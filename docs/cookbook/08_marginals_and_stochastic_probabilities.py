"""Cookbook 8 — Marginals and stochastic probabilities.

Most PPLs can only score what they can write in closed form. The GFI's
`Distribution` contract is weaker — and more powerful: a distribution
must provide an *unbiased estimate* of its density, not the density
itself (Lew et al. 2023's "stochastic probabilities"; reference
`docs/cookbook/inactive/expressivity/stochastic_probabilities.ipynb`,
implementation `inference/sp.py`). That means the MARGINAL of any
generative function — auxiliary randomness integrated out — is itself
a first-class distribution, usable at `@ "addr"` sites inside other
models, with all weight identities still exact *in expectation*.

This page marginalizes a mixture's component indicator and checks the
estimated density against the closed form.
"""

import jax
import jax.numpy as jnp
import jax.scipy.stats as jss

import genjax_xla as g
from genjax_xla.inference import ImportanceK, Target

key = jax.random.key(0)


# -- a two-component mixture, written generatively -----------------------
@g.gen
def mixture():
    hot = g.flip(0.3) @ "hot"
    mu = jnp.where(hot, 4.0, 0.0)
    return g.normal(mu, 1.0) @ "value"


# Marginalize the indicator: `value` alone, `hot` integrated out.
value_dist = mixture.marginal(selection=g.S.at["value"])

# estimate_logpdf returns an UNBIASED estimate of log p(value): each
# call uses fresh auxiliary randomness. Averaging exp(·) over calls
# converges to the true density.
v = 1.0  # note: v=2 would be equidistant from both means (zero-variance weights)
keys = jax.random.split(key, 3000)
est = jax.jit(jax.vmap(
    lambda k: value_dist.estimate_logpdf(k, g.C["value"].set(v))
))(keys)
closed_form = jnp.log(
    0.7 * jnp.exp(jss.norm.logpdf(v, 0.0, 1.0))
    + 0.3 * jnp.exp(jss.norm.logpdf(v, 4.0, 1.0))
)
avg = jax.scipy.special.logsumexp(est) - jnp.log(len(est))
print(f"log p(value=1): estimated {float(avg):.4f}, "
      f"closed form {float(closed_form):.4f}")
assert abs(float(avg - closed_form)) < 5e-2

# Sharper estimates: back the marginal with a K-particle algorithm
# instead of single-draw importance (variance shrinks ~1/K):
value_dist_k = mixture.marginal(
    selection=g.S.at["value"],
    algorithm=ImportanceK(
        Target(mixture, (), g.ChoiceMap.empty()), k_particles=16
    ),
)
est_k = jax.jit(jax.vmap(
    lambda k: value_dist_k.estimate_logpdf(k, g.C["value"].set(v))
))(keys)
print(f"single-draw estimator std {float(jnp.std(est)):.3f} → "
      f"K=16 std {float(jnp.std(est_k)):.3f}")
assert float(jnp.std(est_k)) < float(jnp.std(est))

# -- use the marginal as a site in ANOTHER model -------------------------
# A sensor whose reading follows the mixture, indicator unobservable.
# The outer model never sees "hot" — scores of `reading` are stochastic
# density estimates, and importance weights remain unbiased. A marginal's
# *value* is a choice map over the selected addresses, so the site yields
# (and is constrained by) a nested map:
@g.gen
def outer(shift):
    r = value_dist() @ "reading"   # r is a ChoiceMap: {"value": ...}
    return r["value"] + shift


tr = outer.simulate(key, (1.0,))
print("outer draw:", float(tr.get_retval()),
      " score (density estimate):", float(tr.get_score()))

# Observe the reading (nested constraint — the marginal's value space);
# the weight marginalizes `hot` automatically:
obs = g.C["reading"].set(g.C["value"].set(v))
trs, ws = jax.jit(jax.vmap(
    lambda k: outer.generate(k, obs, (1.0,))
))(keys)
logz = jax.scipy.special.logsumexp(ws) - jnp.log(len(ws))
# With only `reading` in the model, logZ IS the marginal density of v:
assert abs(float(logz - closed_form)) < 5e-2
print("logZ through the outer model:", float(logz))
print("ok")
