"""Device-mesh utilities: the substrate for sharded inference.

This layer is new scope relative to the reference (SURVEY §2.3: the
reference has no distributed backend at all — its only parallel primitive is
single-device ``jax.vmap``). The design: particle/chain axes of
inference algorithms are laid out over a ``jax.sharding.Mesh``; XLA inserts
the device-to-device collectives (psum / all-gather / ppermute) from sharding
annotations, and ``shard_map`` is used where collective placement must be
explicit (distributed resampling).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = [
    "P",
    "Mesh",
    "NamedSharding",
    "particle_mesh",
    "shard_leading_axis",
    "replicated",
    "host_device_mesh",
]


def particle_mesh(devices=None, axis_name: str = "particles") -> Mesh:
    """A 1-D mesh over all (or the given) devices, for sharding the
    particle/chain axis of inference algorithms."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


def host_device_mesh(axis_names=("hosts", "chips")) -> Mesh:
    """A 2-D (processes × local devices) mesh for multi-process runs:
    the first axis spans processes, the second the devices each process
    drives."""
    n_local = jax.local_device_count()
    devs = np.asarray(jax.devices()).reshape(-1, n_local)
    return Mesh(devs, axis_names)


def shard_leading_axis(tree, mesh: Mesh, axis_name: str = "particles"):
    """Constrain every array leaf of ``tree`` to be sharded along its
    leading axis over ``axis_name`` (scalars replicated)."""
    sharding = NamedSharding(mesh, P(axis_name))
    rep = NamedSharding(mesh, P())

    def constrain(x):
        if getattr(x, "ndim", 0) >= 1:
            return jax.lax.with_sharding_constraint(x, sharding)
        return jax.lax.with_sharding_constraint(x, rep)

    return jax.tree_util.tree_map(constrain, tree)


def replicated(tree, mesh: Mesh):
    """Constrain every leaf of ``tree`` to be replicated over ``mesh``."""
    rep = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(
        lambda x: jax.lax.with_sharding_constraint(x, rep), tree
    )
