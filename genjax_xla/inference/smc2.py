"""SMC²: sequential joint inference over parameters AND states of a
state-space model (Chopin, Jacob & Papaspiliopoulos 2013).

New scope relative to the reference (which has no sequential samplers
at all — ``/root/reference/src/genjax/_src/inference/smc.py`` stops at
single-target importance sampling). SMC² maintains N_θ parameter
particles, each carrying its own N_x-particle bootstrap filter; at each
observation the θ-weights multiply by the filters' incremental
likelihood estimates (exact pseudo-marginal weights), and when the
θ-ensemble degenerates it is resampled and every lane is rejuvenated by
a PMMH move targeting p(θ | y_{1:t}) — a fresh inner filter re-run from
scratch over the masked prefix, so the move is an exact MH kernel and
the algorithm never loses the pseudo-marginal guarantee.

Shape: everything is one ``lax.scan`` over time. The state ensemble is
a (N_θ, N_x) lane grid — propagate/weight are elementwise over 65k+
lanes, inner resampling is a per-θ-row systematic scheme (batched
merge-sort ancestors + a per-row gather) — and the O(t)-cost PMMH
re-run is a dynamic-trip-count ``fori_loop`` behind ``lax.cond`` (every θ-lane shares the outer step
index) so the common no-rejuvenation step pays nothing and a firing
pays t, not T, steps. CAVEAT: do NOT ``jax.vmap`` whole SMC² runs —
under vmap the ``lax.cond`` lowers to both-branches-execute, so every
step would pay the full rejuvenation re-run. For replicated runs,
launch separate jit calls (or pmap/shard_map over a replica axis,
which preserves ``cond``); to scale ONE run, shard the θ-lane axis
over the mesh (tests/parallel/test_sharded_smc2.py).

Model interface (theta-first variants of ``pf.particle_filter``'s
batched mode; ``theta`` is any pytree, broadcast over lanes):
- ``init_sampler(key, theta, n) -> (n, ...) states``
- ``propagate(key, theta, xs) -> xs_next``
- ``loglik(theta, xs, y) -> (n,)``
- ``prior_sample(key) -> theta``; ``log_prior(theta) -> float``
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
from jax import lax
from jax.scipy.special import logsumexp

from genjax_xla.inference.pmmh import gaussian_walk_proposal
from genjax_xla.inference.smc import (
    effective_sample_size,
    resample_indices,
    resample_indices_rows,
    resample_indices_sorted,
)

__all__ = ["SMC2Result", "smc2"]


class SMC2Result(NamedTuple):
    thetas: Any              # (N_theta, ...) final parameter particles
    log_weights: jax.Array   # (N_theta,) final theta log-weights
    log_z: jax.Array         # model evidence estimate log p(y_{1:T})
    ess_history: jax.Array   # (T-1,) theta-ESS before assimilating y_t, t=1..T-1
    rejuv_accept: jax.Array  # mean PMMH acceptance over fired rejuvenations


def smc2(
    init_sampler: Callable,
    propagate: Callable,
    loglik: Callable,
    prior_sample: Callable,
    log_prior: Callable,
    n_theta: int,
    n_x: int,
    proposal: Callable | float = 0.1,
    ess_threshold: float = 0.5,
    inner_resampling: str = "systematic",
):
    """Build ``run(key, ys) -> SMC2Result``.

    ``inner_resampling``: ancestor scheme of the per-θ inner filters
    (``"systematic"`` default — one grid offset per row, strictly lower
    offspring variance than ``"multinomial"`` at the same batched-sort
    cost). The θ-resample stays multinomial (a single
    K-sized draw, not on the hot path)."""
    if not callable(proposal):
        proposal = gaussian_walk_proposal(proposal)
    if inner_resampling not in ("systematic", "stratified", "multinomial"):
        raise ValueError(
            f"Unknown resampling method: {inner_resampling!r}"
        )

    def _inner_resample(k_res, lw, xs):
        anc = resample_indices_sorted(
            k_res, lw, n_x, method=inner_resampling
        )
        return jtu.tree_map(lambda v: v[anc], xs)

    def _inner_filter(key, theta, ys, t_mask):
        """Bootstrap filter for one θ over ``ys[0..t_mask]`` inclusive;
        returns (xs, lw_x, logZ). DYNAMIC trip count: inside the
        rejuvenation cond every θ-lane shares the same ``t_mask`` (the
        outer scan's step index), so a ``fori_loop`` re-runs exactly
        ``t_mask`` steps instead of the round-4 full-length masked scan
        — the PMMH re-run cost drops from O(T) to O(t), halving the
        average rejuvenation bill."""
        k0, ks = jax.random.split(key)
        xs = init_sampler(k0, theta, n_x)
        lw = loglik(theta, xs, jtu.tree_map(lambda v: v[0], ys))
        logz = logsumexp(lw) - jnp.log(n_x)

        def body(t, carry):
            xs, lw, logz = carry
            y = jtu.tree_map(lambda v: v[t], ys)
            k_t = jax.random.fold_in(ks, t)
            k_res, k_prop = jax.random.split(k_t)
            xs_r = _inner_resample(k_res, lw, xs)
            xs_new = propagate(k_prop, theta, xs_r)
            lw_new = loglik(theta, xs_new, y)
            incr = logsumexp(lw_new) - jnp.log(n_x)
            return (xs_new, lw_new, logz + incr)

        return lax.fori_loop(1, t_mask + 1, body, (xs, lw, logz))

    def run(key: jax.Array, ys):
        n_steps = jtu.tree_leaves(ys)[0].shape[0]
        k_prior, k_init, k_scan = jax.random.split(key, 3)
        thetas = jax.vmap(
            lambda i: prior_sample(jax.random.fold_in(k_prior, i))
        )(jnp.arange(n_theta))
        xs = jax.vmap(
            lambda i, th: init_sampler(
                jax.random.fold_in(k_init, i), th, n_x
            )
        )(jnp.arange(n_theta), thetas)
        y0 = jtu.tree_map(lambda v: v[0], ys)
        lw_x = jax.vmap(lambda th, x: loglik(th, x, y0))(thetas, xs)
        logz_th = logsumexp(lw_x, axis=1) - jnp.log(n_x)  # (N_theta,)
        w_th = logz_th
        log_z = jnp.zeros(())

        def step(carry, inp):
            t, y = inp
            thetas, xs, lw_x, logz_th, w_th, log_z, acc_sum, acc_n = carry
            k_t = jax.random.fold_in(k_scan, t)
            k_resx, k_prop, k_resth, k_rej = jax.random.split(k_t, 4)

            ess = effective_sample_size(w_th)

            # --- θ-degeneracy: resample + PMMH rejuvenation ----------
            def do_rejuvenate(args):
                thetas, xs, lw_x, logz_th, w_th, log_z, acc_sum, acc_n = args
                # Evidence telescoping: this epoch's normalizer folds
                # into log_z before the weights reset to uniform.
                log_z = log_z + logsumexp(w_th) - jnp.log(n_theta)
                anc = resample_indices(
                    k_resth, w_th, n_theta, method="multinomial"
                )
                thetas_r = jtu.tree_map(lambda v: v[anc], thetas)
                xs_r = jtu.tree_map(lambda v: v[anc], xs)
                lw_r, logz_r = lw_x[anc], logz_th[anc]

                def move(j, th, lz):
                    kj = jax.random.fold_in(k_rej, j)
                    kp, kf, ka = jax.random.split(kj, 3)
                    prop_th = proposal(kp, th)
                    xs_p, lw_p, lz_p = _inner_filter(
                        kf, prop_th, ys, t - 1
                    )
                    log_alpha = (
                        lz_p + log_prior(prop_th) - lz - log_prior(th)
                    )
                    ok = jnp.log(jax.random.uniform(ka)) < log_alpha
                    new_th = jtu.tree_map(
                        lambda p, o: jnp.where(ok, p, jnp.asarray(o)),
                        prop_th, th,
                    )
                    return new_th, xs_p, lw_p, lz_p, ok

                new_th, xs_p, lw_p, lz_p, oks = jax.vmap(move)(
                    jnp.arange(n_theta), thetas_r, logz_r
                )
                xs_out = jtu.tree_map(
                    lambda p, o: jnp.where(
                        oks.reshape((-1,) + (1,) * (p.ndim - 1)), p, o
                    ),
                    xs_p, xs_r,
                )
                lw_out = jnp.where(oks[:, None], lw_p, lw_r)
                lz_out = jnp.where(oks, lz_p, logz_r)
                return (
                    new_th, xs_out, lw_out, lz_out,
                    jnp.zeros_like(w_th), log_z,
                    acc_sum + jnp.sum(oks.astype(jnp.float32)),
                    acc_n + jnp.float32(n_theta),
                )

            (thetas, xs, lw_x, logz_th, w_th, log_z,
             acc_sum, acc_n) = lax.cond(
                ess < ess_threshold * n_theta,
                do_rejuvenate,
                lambda args: args,
                (thetas, xs, lw_x, logz_th, w_th, log_z, acc_sum, acc_n),
            )

            # --- advance every inner filter one observation ----------
            # Row-batched resample (one batched uniform draw; sort-merge
            # ancestors + per-row gather) + one batched key split for
            # propagation.
            anc = resample_indices_rows(
                k_resx, lw_x, n_x, method=inner_resampling
            )
            xs_r = jax.vmap(
                lambda x_j, a_j: jtu.tree_map(lambda v: v[a_j], x_j)
            )(xs, anc)
            prop_keys = jax.random.split(k_prop, n_theta)

            def advance(kp, th, x_r):
                x_new = propagate(kp, th, x_r)
                lw_new = loglik(th, x_new, y)
                incr = logsumexp(lw_new) - jnp.log(n_x)
                return x_new, lw_new, incr

            xs, lw_x, incr = jax.vmap(advance)(
                prop_keys, thetas, xs_r
            )
            logz_th = logz_th + incr
            w_th = w_th + incr
            return (
                thetas, xs, lw_x, logz_th, w_th, log_z, acc_sum, acc_n
            ), ess

        init = (thetas, xs, lw_x, logz_th, w_th, log_z,
                jnp.zeros(()), jnp.zeros(()))
        (thetas, xs, lw_x, logz_th, w_th, log_z, acc_sum, acc_n), ess_hist = (
            lax.scan(
                step, init,
                (jnp.arange(1, n_steps),
                 jtu.tree_map(lambda v: v[1:], ys)),
            )
        )
        # Evidence: Σ over resample epochs of logmeanexp of that
        # epoch's accumulated θ-weights (folded in at each reset
        # above), plus the final open epoch.
        log_z = log_z + logsumexp(w_th) - jnp.log(n_theta)
        return SMC2Result(
            thetas, w_th, log_z, ess_hist,
            jnp.where(acc_n > 0, acc_sum / jnp.maximum(acc_n, 1.0), 0.0),
        )

    return run
