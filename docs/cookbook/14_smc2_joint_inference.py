"""Cookbook 14 — SMC²: sequential joint parameter + state inference.

When a state-space model has unknown PARAMETERS as well as latent
STATES, neither a particle filter (states only) nor MCMC on the
marginal (needs the likelihood, which is itself intractable) suffices
alone. SMC² (`inference/smc2.py`) runs an ensemble of θ-particles, each
carrying its own inner bootstrap filter: the filters' incremental
evidence estimates are exact pseudo-marginal θ-weights, and θ-ensemble
degeneracy triggers a PMMH rejuvenation (a fresh O(t) inner-filter
re-run per proposal, so the move is an exact MH kernel).

Details worth knowing:

- the (N_θ, N_x) state grid advances with one batched systematic
  resample per step: merge-sort ancestors and a per-row gather, the
  O(K log K) form.
- the PMMH re-run is a dynamic-trip `fori_loop` behind the degeneracy
  `lax.cond`: a rejuvenation at time t costs t inner steps, not T.
- do NOT `jax.vmap` whole SMC² runs (vmap turns the cond into
  both-branches-execute); replicate with separate jits or shard the
  θ-axis over a mesh (`tests/parallel/test_sharded_smc2.py`).

Here: a 1-D linear-Gaussian SSM with unknown transition coefficient a,
where the Kalman filter gives p(y | a) exactly — so both the parameter
posterior and the evidence have grid-quadrature oracles to check
against.
"""

import jax
import jax.numpy as jnp
import numpy as np

from genjax_xla.inference.smc2 import smc2
from genjax_xla.models.ssm import (
    lgssm_grid_posterior,
    simulate_lgssm_data,
)

A_TRUE, Q, R, T = 0.7, 0.4, 0.4, 40
key = jax.random.key(7)
_, ys = simulate_lgssm_data(jax.random.key(11), A_TRUE, Q, R, T)

# --- The model, as plain per-ensemble functions -------------------------
# (theta-first variants of the particle filter's batched interface;
# theta broadcasts over the lane axis.)

run = smc2(
    init_sampler=lambda key, a, n: jnp.sqrt(Q)
    * jax.random.normal(key, (n,)),
    propagate=lambda key, a, xs: a * xs
    + jnp.sqrt(Q) * jax.random.normal(key, xs.shape),
    loglik=lambda a, xs, y: jax.scipy.stats.norm.logpdf(
        y, xs, jnp.sqrt(R)
    ),
    prior_sample=lambda key: jax.random.uniform(
        key, minval=-0.95, maxval=0.95
    ),
    log_prior=lambda a: jnp.where(
        jnp.abs(a) < 0.95, -jnp.log(1.9), -jnp.inf
    ),
    n_theta=256,
    n_x=128,
    proposal=0.15,  # gaussian-walk PMMH proposal std
)

res = jax.jit(lambda k: run(k, ys))(key)

# --- Check against the exact Kalman-grid quadrature ---------------------
mean, std, log_ev = lgssm_grid_posterior(
    ys, Q, R, jnp.linspace(-0.949, 0.949, 191)
)
w = np.exp(np.asarray(res.log_weights) - np.asarray(res.log_weights).max())
w /= w.sum()
th = np.asarray(res.thetas)
got_mean = float((th * w).sum())
got_std = float(np.sqrt(((th - got_mean) ** 2 * w).sum()))

print(f"posterior  E[a | y]  = {got_mean:.3f}   (exact {float(mean):.3f})")
print(f"posterior sd[a | y]  = {got_std:.3f}   (exact {float(std):.3f})")
print(f"evidence   log p(y)  = {float(res.log_z):.2f}  "
      f"(exact {float(log_ev):.2f})")
print(f"PMMH acceptance over fired rejuvenations: "
      f"{float(res.rejuv_accept):.2f}")
assert abs(got_mean - float(mean)) < 0.08
assert abs(float(res.log_z) - float(log_ev)) < 1.0

# The theta-ESS history shows the degeneracy/rejuvenation cycle: ESS
# decays as observations sharpen the posterior, and each rejuvenation
# (resample to uniform weights) resets it to N_theta.
ess = np.asarray(res.ess_history)
print(f"theta-ESS: start {ess[0]:.0f}, min {ess.min():.0f}, "
      f"final {ess[-1]:.0f} of {256}")
assert ess.min() < 256  # degeneracy really happened (and was handled)
