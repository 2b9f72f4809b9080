"""Mesh-sharded SMC: particle ensembles laid out over a device mesh, with
log-Z̄ / ESS as mesh-wide reductions and distributed systematic resampling.

Entirely new scope vs. the reference (SURVEY §2.3 / §5: no distributed
backend exists there). The PRODUCT path states its communication
explicitly (``parallel/collectives.py``): deterministic blocked-CDF
offspring counts (an ``all_gather`` of O(N/block) block stats — never the
weight vector), ``psum``-style scalar reductions, and a ``ppermute`` ring
streaming each shard's O(N/D) particle block — so per-device memory stays
O(N/D) and the lowered HLO provably contains no full-size gather
(``tests/parallel/test_collectives.py``). The GSPMD path (sharding
constraints + XLA-chosen collectives) is retained as a comparison
baseline via ``impl="gspmd"``.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import jax.tree_util as jtu

from genjax_xla.gfi.choice_map import ChoiceMap
from genjax_xla.inference.smc import ParticleCollection, resample_tree
from genjax_xla.inference.sp import Target
from genjax_xla.parallel.collectives import (
    ring_resample_step,
    ring_systematic_resample,
)
from genjax_xla.parallel.mesh import Mesh, NamedSharding, P, shard_leading_axis

__all__ = [
    "sharded_importance",
    "sharded_smc_step",
    "sharded_resample",
]


def sharded_importance(
    target: Target,
    k_particles: int,
    mesh: Mesh,
    axis_name: str = "particles",
) -> Callable[[jax.Array], ParticleCollection]:
    """Build a jittable function ``key -> ParticleCollection`` running
    K-particle importance sampling with the particle axis sharded over
    ``mesh[axis_name]``. Per-particle keys derive from ``fold_in`` so the
    result is bitwise-identical for any device layout."""

    def run(key: jax.Array) -> ParticleCollection:
        keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(
            jnp.arange(k_particles)
        )
        keys = shard_leading_axis(keys, mesh, axis_name)
        trs, ws = jax.vmap(target.importance, in_axes=(0, None))(
            keys, ChoiceMap.empty()
        )
        trs = shard_leading_axis(trs, mesh, axis_name)
        ws = shard_leading_axis(ws, mesh, axis_name)
        return ParticleCollection(trs, ws, jnp.asarray(True))

    return run


def sharded_resample(
    collection: ParticleCollection,
    key: jax.Array,
    mesh: Mesh,
    axis_name: str = "particles",
    method: str = "systematic",
    impl: str = "collective",
) -> ParticleCollection:
    """Systematic resampling of a sharded collection.

    ``impl="collective"`` (product path): the explicit ``shard_map``
    ring resampler — O(N/D) per-device memory, deterministic blocked
    CDF, known comm volume (see ``parallel/collectives.py``). The logZ̄
    carried into the equalized weights uses the same layout-independent
    summation, so the output is bitwise identical across mesh layouts.

    ``impl="gspmd"``: the round-2 baseline — the replicated
    ``inference.smc.resample_tree`` under sharding constraints, with XLA
    choosing the redistribution collectives. Kept for A/B comparison."""
    n = collection.num_particles()
    if impl == "collective":
        if method != "systematic":
            raise ValueError(
                "collective sharded_resample implements systematic "
                f"resampling only (got {method!r}); use impl='gspmd' "
                "for other methods"
            )
        new_particles, logz, _ess = ring_resample_step(
            key, collection.get_log_weights(), collection.particles,
            mesh, axis_name,
        )
        lw = shard_leading_axis(
            jnp.full((n,), logz), mesh, axis_name
        )
        return ParticleCollection(new_particles, lw, collection.is_valid)
    new_particles = resample_tree(
        key, collection.get_log_weights(), collection.particles, n, method
    )
    new_particles = shard_leading_axis(new_particles, mesh, axis_name)
    logz = collection.get_log_marginal_likelihood_estimate()
    lw = shard_leading_axis(jnp.full((n,), logz), mesh, axis_name)
    return ParticleCollection(new_particles, lw, collection.is_valid)


def sharded_smc_step(
    target: Target,
    k_particles: int,
    mesh: Mesh,
    axis_name: str = "particles",
    ess_threshold: float = 0.5,
    impl: str = "collective",
) -> Callable[[jax.Array], tuple[ParticleCollection, jax.Array]]:
    """One full sharded SMC step: importance-sample K particles, compute
    log-Z̄ and ESS (mesh-wide reductions), and resample when ESS falls below
    ``ess_threshold * K``. Returns ``(collection, logZ̄)``.

    With ``impl="collective"`` (default) the reductions and the
    resampling run through the explicit-collective product path in one
    fused ``shard_map`` (logZ̄/ESS/ring); ``impl="gspmd"`` keeps the
    round-2 GSPMD baseline."""

    importance = sharded_importance(target, k_particles, mesh, axis_name)

    def step(key: jax.Array):
        key, res_key = jax.random.split(key)
        collection = importance(key)
        if impl == "collective":
            new_particles, logz, ess = ring_resample_step(
                res_key, collection.get_log_weights(),
                collection.particles, mesh, axis_name,
            )
            lw = shard_leading_axis(
                jnp.full((k_particles,), logz), mesh, axis_name
            )
            resampled = ParticleCollection(
                new_particles, lw, collection.is_valid
            )
        else:
            logz = collection.get_log_marginal_likelihood_estimate()
            ess = collection.effective_sample_size()
            resampled = sharded_resample(
                collection, res_key, mesh, axis_name, impl="gspmd"
            )
        out = jax.tree_util.tree_map(
            lambda a, b: jnp.where(ess < ess_threshold * k_particles, a, b),
            resampled,
            collection,
        )
        return out, logz

    return step
