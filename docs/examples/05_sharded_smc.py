"""Mesh-sharded SMC: particle axis over all devices, logZ/ESS as
collectives. Run with XLA_FLAGS=--xla_force_host_platform_device_count=8
on CPU to simulate a pod slice."""

import jax

import genjax_xla as g
from genjax_xla.inference import Target
from genjax_xla.parallel import particle_mesh, sharded_smc_step


@g.gen
def beta_bernoulli(a, b):
    p = g.beta(a, b) @ "p"
    v = g.flip(p) @ "v"
    return v


if __name__ == "__main__":
    mesh = particle_mesh()
    print("mesh:", mesh)
    target = Target(beta_bernoulli, (2.0, 2.0), g.C["v"].set(True))
    step = sharded_smc_step(target, 1 << 16, mesh)
    collection, logz = jax.jit(step)(jax.random.key(0))
    print("logZ:", logz, "(exact: log 0.5 = -0.693)")
    print("weights sharded over:",
          len(collection.get_log_weights().sharding.device_set), "devices")
