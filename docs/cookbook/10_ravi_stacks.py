"""Cookbook 10 — Nested approximate marginalization (RAVI stacks).

How to be *recursively wrong everywhere yet correct at the end*
(parity with the reference cookbook's `ravi_stack.ipynb`, reference
`docs/cookbook/inactive/expressivity/`): every density in this file is
only ever ESTIMATED — the model marginalizes an auxiliary variable, the
proposal marginalizes its own auxiliary variable, and importance
sampling runs with estimates on both sides of the weight. Proper
weighting (Lew et al. 2023) guarantees the final log-Z estimate is
still unbiased, and we check that against a closed form.

The stack, bottom to top:

1. `mixture_xy` — 3-component 2-D Gaussian mixture; the component
   index is marginalized out (`.marginal()`), giving a chm-valued
   distribution over {"x","y"} whose density is only estimable.
2. `model` — uses that marginal AS A SITE ("pt") and observes a
   function of it. The target's latent is the nested choice map at
   "pt".
3. `guess` — a data-driven proposal that picks its own auxiliary
   cluster guess from the observation, proposes near that cluster,
   and marginalizes the guess out so its traces match the model's
   address space (the reference's "the model doesn't know what to do
   with 'cluster_idx'" step).
"""

import jax
import jax.numpy as jnp
import numpy as np

import genjax_xla as g
from genjax_xla.inference import ImportanceK, Target

key = jax.random.key(0)

# Cluster 1 far away; clusters 2a/2b close together (the reference's
# "informally, cluster 1 vs cluster 2" setup).
LOGITS = jnp.log(jnp.array([0.4, 0.3, 0.3]))
MUX = jnp.array([-6.0, 3.0, 4.0])
MUY = jnp.array([-6.0, 3.5, 4.5])


@g.gen
def mixture_xy():
    idx = g.categorical(LOGITS) @ "idx"
    x = g.normal(MUX[idx], 1.0) @ "x"
    y = g.normal(MUY[idx], 1.0) @ "y"
    return x + y


# Level 1: marginalize the component index. `point` is a chm-valued
# SampleDistribution over {"x","y"} — its density can only be
# estimated (here by the default 1-particle importance).
point = mixture_xy.marginal(selection=g.S.at["x"] | g.S.at["y"])


# Level 2: the marginal as a site, with a downstream observation.
@g.gen
def model():
    pt = point() @ "pt"
    _ = g.normal(pt["x"] + pt["y"], 0.5) @ "obs"


OBS = 6.9  # near cluster 2's x+y ≈ 7..9
target = Target(model, (), g.C["obs"].set(OBS))

# Closed-form oracle: x+y | idx=k ~ N(MUX_k + MUY_k, sqrt(2)), so
# obs ~ Σ_k w_k · N(MUX_k + MUY_k, sqrt(2 + 0.25)).
w = jax.nn.softmax(LOGITS)
exact_logz = float(jax.scipy.special.logsumexp(
    jnp.log(w) + jax.scipy.stats.norm.logpdf(
        OBS, MUX + MUY, jnp.sqrt(2.0 + 0.25)
    )
))


# Level 3: a data-driven proposal with ITS OWN auxiliary variable — a
# hard cluster guess from the observation — marginalized out so the
# proposed trace only contains the model's latent address "pt".
@g.gen
def guess_pt(cx, cy):
    # The nested shape of the model's marginal site: a chm {"x","y"}.
    x = g.normal(cx, 1.2) @ "x"
    y = g.normal(cy, 1.2) @ "y"
    return x + y


@g.gen
def guess_aux(target: Target):
    obs = target["obs"]
    # Data-driven logic: far-away cluster 1 has x+y ≈ -12.
    p_far = jax.nn.sigmoid(-(obs + 2.0))
    far = g.flip(p_far) @ "cluster_idx"
    cx = jnp.where(far, MUX[0], 0.5 * (MUX[1] + MUX[2]))
    cy = jnp.where(far, MUY[0], 0.5 * (MUY[1] + MUY[2]))
    return guess_pt(cx, cy) @ "pt"


# Marginalize the guess: traces now match the model's address space.
guess = guess_aux.marginal(selection=g.S.at["pt"])


def logz_samples(q, n=1500, k_particles=4):
    alg = ImportanceK(target, q=q, k_particles=k_particles)
    keys = jax.random.split(key, n)
    return jax.jit(jax.vmap(
        lambda kk: alg.run_smc(kk).get_log_marginal_likelihood_estimate()
    ))(keys)


lz_prior = logz_samples(None)
lz_ravi = logz_samples(guess)

# Unbiasedness at the top of the stack, despite estimated densities at
# every level below: E[exp(logẐ)] = Z for both proposals.
for name, lz in [("prior", lz_prior), ("ravi", lz_ravi)]:
    log_mean = float(
        jax.scipy.special.logsumexp(lz) - jnp.log(lz.shape[0])
    )
    assert abs(log_mean - exact_logz) < 0.12, (name, log_mean, exact_logz)

# The data-driven stack concentrates its weights: lower variance of
# the log-Z samples than the prior proposal.
v_prior = float(jnp.var(lz_prior))
v_ravi = float(jnp.var(lz_ravi))
assert v_ravi < v_prior, (v_ravi, v_prior)

print("cookbook 10 ok:",
      f"exact={exact_logz:.3f}",
      f"var prior={v_prior:.3f} ravi={v_ravi:.3f}")
