"""Trace-level particle filtering: condition a scanned generative model on
its observations one time-step at a time, entirely through the GFI — each
assimilation step is an ``IndexRequest`` single-step repair (O(1) per step
thanks to the Scan fast path), so the whole filter is O(T) like a
hand-written one, but model-agnostic: the particles ARE model traces, and
any per-step quantity (posterior paths, retvals, subtrace scores) is
available afterwards.

This is the GFI-native counterpart of the state-level
``genjax_xla.inference.pf.particle_filter`` (which is faster but requires
hand-written init/step kernels).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
from jax import lax
from jax.scipy.special import logsumexp

from genjax_xla.gfi.choice_map import ChoiceMap
from genjax_xla.gfi.concepts import IndexRequest
from genjax_xla.gfi.requests import Update
from genjax_xla.core.compiler.taint import variant_leaf_mask
from genjax_xla.inference.smc import (
    effective_sample_size,
    resample_tree,
)

__all__ = ["trace_particle_filter", "TracePFResult"]


class TracePFResult(NamedTuple):
    traces: Any            # particle traces (leading axis K), fully conditioned
    log_weights: jax.Array
    log_z: jax.Array
    ess_history: jax.Array


def trace_particle_filter(
    scan_model,
    model_args: tuple,
    obs_address: str,
    observations: jax.Array,
    n_particles: int,
    ess_threshold: float = 0.5,
    resampling: str = "systematic",
    refresh_future: bool = False,
):
    """Build ``run(key) -> TracePFResult`` for a ``Scan`` model whose step
    records an observation at ``(t, obs_address)``.

    Each time step t: constrain step t's observation via
    ``IndexRequest(t, Update(...))`` on every particle (the SMCP3 edit
    weight is the incremental likelihood), update weights, and resample
    adaptively.

    ``refresh_future=True``: after each resampling, Regenerate all steps
    > t−1 of every particle (a weight-0 prior refresh of the cloned
    futures) — this makes the filter *exactly* the bootstrap PF (no
    shared-future variance), at O(T) extra work per step."""
    from genjax_xla.gfi.requests import Regenerate
    from genjax_xla.gfi.selection import Selection

    n_steps = jtu.tree_leaves(observations)[0].shape[0]

    def run(key: jax.Array) -> TracePFResult:
        k_init, k_scan = jax.random.split(key)
        init_keys = jax.vmap(
            lambda i: jax.random.fold_in(k_init, i)
        )(jnp.arange(n_particles))
        trs = jax.vmap(
            lambda k: scan_model.simulate(k, model_args)
        )(init_keys)

        # Ensemble-invariant leaves (model args and other key-free
        # data; the observation choices are sampled at build and so
        # stay conservatively variant-marked) skip the resampling
        # expansion — see core/compiler/taint.py.
        invariant = jtu.tree_map(
            lambda variant: not variant,
            variant_leaf_mask(
                lambda k: scan_model.simulate(k, model_args),
                jax.random.key(0),
            ),
        )

        def step(carry, inp):
            t, obs_t = inp
            trs, lw, log_z = carry
            k_t = jax.random.fold_in(k_scan, t)
            k_res, k_refresh, k_edit = jax.random.split(k_t, 3)

            # Adaptive resampling on current weights.
            ess = effective_sample_size(lw)

            def do_resample(args):
                trs, lw, log_z = args
                trs = resample_tree(k_res, lw, trs, n_particles,
                                    resampling, invariant=invariant)
                if refresh_future:
                    # Prior-refresh of the cloned futures (steps >= t):
                    # the Regenerate weight is exactly 0 (nothing
                    # downstream of the regenerated sites is constrained
                    # yet), so logZ bookkeeping is untouched.
                    req = Regenerate(Selection.idx_above(t - 1))

                    def refresh(i, tr):
                        pk = jax.random.fold_in(k_refresh, i)
                        new_tr, _w, _rd, _bwd = tr.edit(pk, req)
                        return new_tr

                    trs = jax.vmap(refresh)(
                        jnp.arange(n_particles), trs
                    )
                log_z = log_z + logsumexp(lw) - jnp.log(n_particles)
                return trs, jnp.zeros_like(lw), log_z

            trs, lw, log_z = lax.cond(
                ess < ess_threshold * n_particles,
                do_resample,
                lambda args: args,
                (trs, lw, log_z),
            )

            # Assimilate observation t on every particle: O(1) per step
            # via the Scan IndexRequest repair. The PF increment is
            # log p(obs_t | x_t): the Update edit weight is the ratio
            # new_site − old_site, so add back the discarded prior draw's
            # site score (the carry never depends on observation sites —
            # the same contract the O(1) repair itself requires).
            req = IndexRequest(
                t, Update(ChoiceMap.entry(obs_t, obs_address))
            )

            def per_particle(i, tr):
                pk = jax.random.fold_in(k_edit, i)
                old_y_score = (
                    tr.get_inner_trace(t)
                    .get_inner_trace(obs_address)
                    .get_score()
                )
                new_tr, w, _rd, _bwd = tr.edit(pk, req)
                return new_tr, w + old_y_score

            trs, incr = jax.vmap(per_particle)(
                jnp.arange(n_particles), trs
            )
            lw = lw + incr
            return (trs, lw, log_z), ess

        (trs, lw, log_z), ess_hist = lax.scan(
            step,
            (trs, jnp.zeros(n_particles), jnp.zeros(())),
            (jnp.arange(n_steps), observations),
        )
        log_z = log_z + logsumexp(lw) - jnp.log(n_particles)
        return TracePFResult(trs, lw, log_z, ess_hist)

    return run
