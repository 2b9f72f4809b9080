"""Mesh-sharded SMC²: the θ-lane axis under a GSPMD sharding constraint
is bitwise layout-independent (fold_in keys per θ-lane; inner filters
are per-lane vmaps)."""

import jax
import jax.numpy as jnp
import numpy as np

from genjax_xla.inference.smc2 import smc2
from genjax_xla.models.ssm import simulate_lgssm_data
from genjax_xla.parallel.mesh import (
    Mesh,
    particle_mesh,
    shard_leading_axis,
)

KEY = jax.random.key(314159)
A_TRUE, Q, R, T = 0.7, 0.4, 0.4, 20


YS = simulate_lgssm_data(jax.random.key(11), A_TRUE, Q, R, T)[1]


def _run(mesh):
    run = smc2(
        lambda key, a, n: jnp.sqrt(Q) * jax.random.normal(key, (n,)),
        lambda key, a, xs: a * xs
        + jnp.sqrt(Q) * jax.random.normal(key, xs.shape),
        lambda a, xs, y: jax.scipy.stats.norm.logpdf(y, xs, jnp.sqrt(R)),
        lambda key: jax.random.uniform(key, minval=-0.95, maxval=0.95),
        lambda a: jnp.where(jnp.abs(a) < 0.95, -jnp.log(1.9), -jnp.inf),
        n_theta=64, n_x=64, proposal=0.2,
    )

    def sharded(key):
        res = run(key, YS)
        if mesh is not None:
            res = res._replace(
                thetas=shard_leading_axis(res.thetas, mesh, "particles"),
                log_weights=shard_leading_axis(
                    res.log_weights, mesh, "particles"
                ),
            )
        return res

    return jax.jit(sharded)(KEY)


def test_sharded_theta_lanes_bitwise():
    r8 = _run(particle_mesh())
    r1 = _run(Mesh(np.asarray(jax.devices()[:1]), ("particles",)))
    np.testing.assert_array_equal(
        np.asarray(r8.thetas), np.asarray(r1.thetas)
    )
    np.testing.assert_array_equal(
        np.asarray(r8.log_z), np.asarray(r1.log_z)
    )
    assert len(r8.thetas.sharding.device_set) == 8
