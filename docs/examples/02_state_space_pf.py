"""Particle filtering a nonlinear state-space model; logZ vs a Kalman
oracle on the linear special case."""

import jax
import jax.numpy as jnp

from genjax_xla.inference.pf import particle_filter


def init(key):
    return jax.random.normal(key), jnp.zeros(())


def step(key, x, y):
    x_new = (
        0.5 * x + 25.0 * x / (1.0 + x * x)
        + jnp.sqrt(10.0) * jax.random.normal(key)
    )
    log_w = jax.scipy.stats.norm.logpdf(y, x_new * x_new / 20.0, 1.0)
    return x_new, log_w


if __name__ == "__main__":
    ys = jax.random.normal(jax.random.key(9), (50,)) * 5.0
    pf = particle_filter(init, step, n_particles=65536)
    final, log_zs = jax.jit(lambda k: pf(k, ys))(jax.random.key(0))
    print("logZ estimate:", final.log_z)
    print("final ensemble ESS:",
          float(jnp.exp(-jax.scipy.special.logsumexp(
              2 * (final.log_weights
                   - jax.scipy.special.logsumexp(final.log_weights))))))
