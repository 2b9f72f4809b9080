"""Particle marginal Metropolis–Hastings (PMMH): exact-approximation
parameter inference for state-space models.

New scope relative to the reference (no parameter-inference drivers
exist there; its MCMC artifacts are per-trace edit requests). PMMH
(Andrieu, Doucet & Holenstein 2010) targets p(θ | y_{1:T}) exactly by
plugging an UNBIASED likelihood estimator — here a particle filter's
ẑ(θ) — into a Metropolis–Hastings chain: the extended chain over
(θ, all filter randomness) leaves the exact posterior invariant no
matter the particle count (which only affects mixing).

Shape: the whole chain is one ``lax.scan``; each sweep runs
the full particle filter for the proposed θ (itself one inner scan over
time with the ensemble as a vector lane axis), so the device sees a long
stream of wide vector steps and the chain never leaves the device.
Multiple chains vmap/shard over the usual mesh axis.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
from jax import lax

__all__ = ["PMMHResult", "pmmh", "gaussian_walk_proposal"]


class PMMHResult(NamedTuple):
    thetas: Any             # (n_iters, ...) parameter chain
    log_zs: jax.Array       # (n_iters,) retained logZ estimates
    accept_rate: jax.Array  # scalar
    final_theta: Any


def gaussian_walk_proposal(step_std):
    """Symmetric Gaussian random-walk proposal over a θ pytree.
    ``step_std`` is a scalar (broadcast to every leaf) or a pytree
    exactly matching θ's structure (per-leaf stds); any other
    structure raises at proposal time rather than silently
    broadcasting."""

    def propose(key, theta):
        leaves, treedef = jtu.tree_flatten(theta)
        std_leaves = jtu.tree_leaves(step_std)
        if jtu.tree_structure(step_std) == treedef:
            stds = std_leaves
        elif len(std_leaves) == 1 and jnp.ndim(std_leaves[0]) == 0:
            stds = [std_leaves[0]] * len(leaves)
        else:
            raise TypeError(
                "gaussian_walk_proposal: step_std must be a scalar or "
                f"a pytree matching theta (theta structure {treedef}, "
                f"step_std structure {jtu.tree_structure(step_std)})"
            )
        keys = jax.random.split(key, len(leaves))
        new = [
            jnp.asarray(l)
            + jnp.asarray(s) * jax.random.normal(k, jnp.shape(l))
            for l, s, k in zip(leaves, stds, keys)
        ]
        return jtu.tree_unflatten(treedef, new)

    return propose


def pmmh(
    log_marginal_est: Callable,
    log_prior: Callable,
    n_iters: int,
    proposal: Callable | float = 0.1,
):
    """Build ``run(key, theta0) -> PMMHResult``.

    - ``log_marginal_est(key, theta) -> logẐ``: any unbiased marginal-
      likelihood estimator — e.g. close a
      :func:`~genjax_xla.inference.pf.particle_filter` (or
      ``models.hmm_bootstrap_filter``) over the observations and return
      its ``log_z``. Unbiasedness of ``exp(logẐ)`` is what makes the
      chain exact (pseudo-marginal argument).
    - ``log_prior(theta) -> float``: log prior density of θ.
    - ``proposal``: a float (Gaussian random-walk std) or a callable
      ``(key, theta) -> theta'`` implementing a SYMMETRIC proposal.
    """
    if not callable(proposal):
        proposal = gaussian_walk_proposal(proposal)

    def run(key: jax.Array, theta0):
        k_init, k_scan = jax.random.split(key)
        lz0 = log_marginal_est(k_init, theta0)

        def sweep(carry, i):
            theta, lz = carry
            k_i = jax.random.fold_in(k_scan, i)
            k_prop, k_est, k_acc = jax.random.split(k_i, 3)
            prop = proposal(k_prop, theta)
            lzp = log_marginal_est(k_est, prop)
            log_alpha = lzp + log_prior(prop) - lz - log_prior(theta)
            accept = (
                jnp.log(jax.random.uniform(k_acc)) < log_alpha
            )
            theta = jtu.tree_map(
                lambda p, t: jnp.where(accept, p, jnp.asarray(t)),
                prop, theta,
            )
            lz = jnp.where(accept, lzp, lz)
            return (theta, lz), (theta, lz, accept)

        (theta_T, _), (thetas, lzs, accepts) = lax.scan(
            sweep, (theta0, lz0), jnp.arange(n_iters)
        )
        return PMMHResult(
            thetas, lzs, jnp.mean(accepts.astype(jnp.float32)), theta_T
        )

    return run
