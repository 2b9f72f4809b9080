"""Multi-device inference patterns (the sharded product paths).

Three pieces on one mesh:
1. the explicit-collective sharded particle filter — deterministic
   blocked reductions + halo-exchange resampling, bitwise identical on
   ANY device layout;
2. chains-sharded warmup-adapted NUTS — cross-chain adaptation rides
   deterministic collectives, so results equal the single-device run;
3. elastic recovery — re-laying a sharded ensemble onto a shrunken
   device set with `mesh_place`.

Run with ``XLA_FLAGS=--xla_force_host_platform_device_count=8`` on CPU
to simulate eight devices; the same code targets real devices unchanged.
"""

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

import genjax_xla as g
from genjax_xla.inference import Target, run_nuts
from genjax_xla.parallel import particle_mesh, sharded_particle_filter


def sharded_filter_demo():
    mesh = particle_mesh()

    def init(key):
        return jax.random.normal(key), jnp.zeros(())

    def step(key, x, y):
        x_new = 0.9 * x + 0.3 * jax.random.normal(key)
        return x_new, jax.scipy.stats.norm.logpdf(y, x_new, 0.5)

    ys = jnp.asarray([0.1, -0.2, 0.3, 0.0, 0.4])
    pf = sharded_particle_filter(init, step, 1 << 14, mesh)
    final, _ = jax.jit(lambda k: pf(k, ys))(jax.random.key(0))
    print("sharded PF logZ:", float(final.log_z), "on",
          len(final.log_weights.sharding.device_set), "devices")

    # The product path is bitwise layout-independent: a 1-device mesh
    # gives the same bits.
    mesh1 = Mesh(np.asarray(jax.devices()[:1]), ("particles",))
    pf1 = sharded_particle_filter(init, step, 1 << 14, mesh1)
    final1, _ = jax.jit(lambda k: pf1(k, ys))(jax.random.key(0))
    assert float(final.log_z) == float(final1.log_z)
    print("bitwise equal on a 1-device mesh: True")
    return final


def sharded_nuts_demo():
    @g.gen
    def hier():
        mu = g.normal(0.0, 1.0) @ "mu"
        tau = g.normal(0.0, 1.0) @ "tau"
        _ = g.normal(mu, jnp.exp(tau)) @ "y"

    target = Target(hier, (), g.C["y"].set(1.0))
    mesh = Mesh(np.asarray(jax.devices()), ("chains",))
    chms, _ = jax.jit(
        lambda k: run_nuts(
            target, k, n_chains=64, num_warmup=50, num_samples=50,
            max_depth=5, mesh=mesh,
        )
    )(jax.random.key(1))
    print("sharded NUTS: mu posterior mean",
          round(float(chms["mu"].mean()), 3), "- chains over",
          len(chms["mu"].sharding.device_set), "devices")
    return chms


def elastic_demo(final):
    from genjax_xla.utils.failure import mesh_place

    half = jax.devices()[: len(jax.devices()) // 2]
    placed = mesh_place("particles")(final, half)
    same = bool(
        np.array_equal(np.asarray(placed.log_weights),
                       np.asarray(final.log_weights))
    )
    print("elastic down-shift:",
          len(final.log_weights.sharding.device_set), "->",
          len(placed.log_weights.sharding.device_set), "devices;",
          "values unchanged:", same)


if __name__ == "__main__":
    final = sharded_filter_demo()
    sharded_nuts_demo()
    elastic_demo(final)
