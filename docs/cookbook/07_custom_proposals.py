"""Cookbook 7 — Custom proposals: putting knowledge into inference.

Importance sampling with the prior as proposal wastes particles
wherever the posterior disagrees with the prior. Any generative
function can serve as a proposal instead: wrap it with `.marginal()`
(making it a `SampleDistribution` over choice maps) and pass it as
`q` to `Importance`/`ImportanceK`. The proposal receives the `Target`
as its argument, so it can READ the observations and aim.

Parity with the reference cookbook's `custom_proposal.ipynb`
(reference `docs/cookbook/inactive/inference/`); the q-weighted SMC
algebra is `inference/smc.py` (reference `smc.py:233-279`).
"""

import jax
import jax.numpy as jnp

import genjax_xla as g
from genjax_xla.inference import Importance, Target

key = jax.random.key(0)


# -- the model: conjugate normal-normal, so we know the exact answer ----
@g.gen
def model():
    x = g.normal(0.0, 1.0) @ "x"
    g.normal(x, 0.5) @ "y"
    return x


y_obs = 2.0
target = Target(model, (), g.C["y"].set(y_obs))
# Exact posterior: x | y ~ N(y·0.8, sqrt(0.2)); logZ = log N(y; 0, sqrt(1.25)).
post_mean, post_std = y_obs * 0.8, jnp.sqrt(0.2)
exact_logz = jax.scipy.stats.norm.logpdf(y_obs, 0.0, jnp.sqrt(1.25))


# -- proposal 1: the prior (what you get with q=None) --------------------
# -- proposal 2: reads the observation and aims near the posterior -------
@g.gen
def smart(target: Target):
    y = target["y"]                      # look at the data!
    return g.normal(0.8 * y, 0.5) @ "x"  # near-posterior (std slightly wide)


def logw_samples(q, n=2000):
    alg = Importance(target, q=q)
    keys = jax.random.split(key, n)

    def one(k):
        col = alg.run_smc(k)
        return col.get_log_weights()[0]

    return jax.jit(jax.vmap(one))(keys)


lw_prior = logw_samples(None)
lw_smart = logw_samples(smart.marginal())

# Both are unbiased estimators of the SAME logZ...
for name, lw in [("prior", lw_prior), ("smart", lw_smart)]:
    logz = jax.scipy.special.logsumexp(lw) - jnp.log(len(lw))
    print(f"{name:6s} logZ ≈ {float(logz):+.4f}  (exact {float(exact_logz):+.4f})"
          f"   var[log w] = {float(jnp.var(lw)):.3f}")
    assert abs(float(logz - exact_logz)) < 0.1

# ...but the aimed proposal's weights are far flatter — that variance
# is exactly what ESS measures, and what costs you particles in SMC:
assert float(jnp.var(lw_smart)) < 0.25 * float(jnp.var(lw_prior))


# The effective sample size tells the same story per-particle-budget:
def ess_frac(lw):
    w = jnp.exp(lw - jax.scipy.special.logsumexp(lw))
    return 1.0 / (jnp.sum(w * w) * len(lw))


print(f"ESS fraction: prior {float(ess_frac(lw_prior)):.2f}, "
      f"smart {float(ess_frac(lw_smart)):.2f}")

# A perfect proposal (the exact posterior) would give constant weights
# (= logZ exactly, ESS 1.0). Try it: replace 0.5 with sqrt(0.2) above —
# var[log w] collapses to ~0. Proposals don't change WHAT you estimate,
# only how many particles it takes.
print("ok")
