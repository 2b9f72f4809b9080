"""Mesh-sharded particle filtering: the particle axis of
:func:`genjax_xla.inference.pf.particle_filter` laid out over a device
mesh (benchmark config 4: 1M particles across devices).

Product path (``use_collectives=True``, default): weight reductions and
systematic resampling run through the explicit-collective
``shard_map`` implementations in ``parallel/collectives.py`` —
deterministic blocked-CDF summation (bitwise layout-independent
outputs), O(N/D) per-device memory, and a ``ppermute`` ring for the
ancestor redistribution, so the comm volume is known by construction
(``docs/comm_model.json``). ``use_collectives=False`` keeps the GSPMD
baseline: the replicated reductions/resampler under sharding
constraints, with XLA choosing the collectives."""

from __future__ import annotations

from typing import Callable

import jax.numpy as jnp

from genjax_xla.inference.pf import particle_filter
from genjax_xla.parallel.collectives import (
    blocked_stats,
    ring_systematic_resample,
)
from genjax_xla.parallel.mesh import Mesh, shard_leading_axis

__all__ = ["sharded_particle_filter"]


def sharded_particle_filter(
    init: Callable,
    step: Callable,
    n_particles: int,
    mesh: Mesh,
    axis_name: str | tuple = "particles",
    ess_threshold: float = 0.5,
    resampling: str = "systematic",
    batched: bool = False,
    use_collectives: bool = True,
):
    """Like :func:`particle_filter`, with the ensemble pinned to
    ``mesh[axis_name]`` throughout the scan. Per-particle keys derive from
    ``fold_in`` (non-batched path), so results are bitwise-identical
    across device layouts (with ``use_collectives=True`` this extends to
    the weight reductions and the resampled ensemble — the blocked-CDF
    summation order is layout-independent)."""
    stats_fn = None
    resample_fn = None
    if use_collectives:
        if resampling != "systematic":
            raise ValueError(
                "use_collectives=True implements systematic resampling "
                f"only (got {resampling!r}); pass use_collectives=False"
            )
        log_n = jnp.log(n_particles)

        def stats_fn(lw):
            logz, ess = blocked_stats(lw, mesh, axis_name)
            return logz + log_n, ess

        def resample_fn(key, lw, particles):
            return ring_systematic_resample(
                key, lw, particles, mesh, axis_name
            )

    return particle_filter(
        init,
        step,
        n_particles,
        ess_threshold,
        resampling,
        batched=batched,
        shard_constraint=lambda tree: shard_leading_axis(
            tree, mesh, axis_name
        ),
        stats_fn=stats_fn,
        resample_fn=resample_fn,
    )
