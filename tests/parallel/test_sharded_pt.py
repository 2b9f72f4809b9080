"""Parallel tempering with the replica axis sharded over the virtual
8-device mesh: the roll-and-select swap phase lowers to neighbor
collectives under GSPMD, and results are bitwise layout-independent
(fold_in-derived keys, repo convention)."""

import jax
import jax.numpy as jnp
import numpy as np

import genjax_xla as g
from genjax_xla.inference import Target
from genjax_xla.inference.pt import parallel_tempering
from genjax_xla.inference.requests.rejuvenate import Rejuvenate
from genjax_xla.parallel import Mesh, particle_mesh, shard_leading_axis

KEY = jax.random.key(314159)


@g.gen
def conjugate_normal(obs_std):
    mu = g.normal(0.0, 1.0) @ "mu"
    y = g.normal(mu, obs_std) @ "y"
    return y


def drift_request():
    @g.gen
    def drift(old):
        mu = g.normal(old["mu"], 0.4) @ "mu"
        return mu

    return Rejuvenate(drift)


def _run(mesh, n_steps=600):
    tgt = Target(conjugate_normal, (0.5,), g.C["y"].set(1.0))
    run = parallel_tempering(
        tgt, jnp.linspace(0.0, 1.0, 8), make_request=drift_request
    )

    def sharded(key):
        res = run(key, n_steps,
                  collect=lambda tr: tr.get_choices()["mu"])
        traces = (
            shard_leading_axis(res.traces, mesh, "particles")
            if mesh is not None else res.traces
        )
        return res._replace(traces=traces)

    return jax.jit(sharded)(KEY)


def test_sharded_replicas_match_single_device_bitwise():
    res8 = _run(particle_mesh())
    res1 = _run(Mesh(np.asarray(jax.devices()[:1]), ("particles",)))
    np.testing.assert_array_equal(
        np.asarray(res8.samples), np.asarray(res1.samples)
    )
    np.testing.assert_array_equal(
        np.asarray(res8.swap_rate), np.asarray(res1.swap_rate)
    )


def test_sharded_replica_layout_and_correctness():
    res = _run(particle_mesh(), n_steps=2500)
    lw = jax.tree_util.tree_leaves(res.traces)[0]
    assert len(lw.sharding.device_set) == 8
    mus = np.asarray(res.samples)[500:]
    assert abs(mus.mean() - 0.8) < 6e-2
