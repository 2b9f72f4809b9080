"""Distributed inference over device meshes (XLA collectives between
the devices of a mesh)."""

from genjax_xla.parallel.mesh import (
    Mesh,
    NamedSharding,
    P,
    host_device_mesh,
    particle_mesh,
    replicated,
    shard_leading_axis,
)
from genjax_xla.parallel.bootstrap import (
    init_distributed,
    is_multihost,
    local_particle_slice,
)
from genjax_xla.parallel.collectives import (
    blocked_ess,
    blocked_logz,
    blocked_stats,
    ring_resample_step,
    ring_systematic_resample,
    shardmap_ess,
    shardmap_logz,
    shardmap_systematic_resample,
)
from genjax_xla.parallel.pf import sharded_particle_filter
from genjax_xla.parallel.seq import time_sharded_filter
from genjax_xla.parallel.smc import (
    sharded_importance,
    sharded_resample,
    sharded_smc_step,
)
from genjax_xla.parallel.svgd import run_sharded_svgd, sharded_svgd_step

__all__ = [
    "Mesh",
    "NamedSharding",
    "P",
    "blocked_ess",
    "blocked_logz",
    "blocked_stats",
    "ring_resample_step",
    "ring_systematic_resample",
    "shardmap_ess",
    "shardmap_logz",
    "shardmap_systematic_resample",
    "host_device_mesh",
    "init_distributed",
    "is_multihost",
    "local_particle_slice",
    "particle_mesh",
    "replicated",
    "shard_leading_axis",
    "run_sharded_svgd",
    "sharded_importance",
    "sharded_particle_filter",
    "sharded_resample",
    "sharded_smc_step",
    "sharded_svgd_step",
    "time_sharded_filter",
]
