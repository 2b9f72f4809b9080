"""Multi-process group bootstrap for inference across hosts.

When several processes share one computation, call
:func:`init_distributed` once per process before any jax computation;
afterwards ``jax.devices()`` spans every process's devices and the mesh
helpers in :mod:`genjax_xla.parallel.mesh` lay inference axes over them.
Single-process environments (and the CPU test mesh) skip initialization
and work unchanged.

This is the SURVEY §2.3 "jax.distributed bootstrap" layer; it cannot be
exercised in a single-host CI but is the documented entry point for
multi-host deployment.
"""

from __future__ import annotations

import jax

__all__ = ["init_distributed", "is_multihost", "local_particle_slice"]


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Initialize the multi-process group. With no arguments, uses JAX's
    auto-detection of the cluster environment, where one exists; name
    the coordinator, the process count and this process's id otherwise."""
    if num_processes is not None and num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def is_multihost() -> bool:
    return jax.process_count() > 1


def local_particle_slice(n_particles: int) -> tuple[int, int]:
    """The [start, stop) range of the global particle axis owned by this
    host under an even layout — for host-local IO (checkpoint shards,
    observation feeding)."""
    per_host = n_particles // jax.process_count()
    start = jax.process_index() * per_host
    return start, start + per_host
