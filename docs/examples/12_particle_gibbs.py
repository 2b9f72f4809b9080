"""Particle Gibbs: exact joint smoothing posteriors by iterated
conditional SMC — array-level PGAS and the GFI-native trace version,
both checked against the exact RTS smoother."""

import jax
import jax.numpy as jnp
import numpy as np

import genjax_xla as g
from genjax_xla.inference import particle_gibbs, trace_particle_gibbs
from genjax_xla.models import kalman_smoother

if __name__ == "__main__":
    A, Q, R, T = 0.9, 0.5, 0.5, 10
    from genjax_xla.models import simulate_lgssm_data

    _, ys = simulate_lgssm_data(jax.random.key(7), A, Q, R, T)

    # --- array-level PGAS: hand-written kernels, ancestor sampling ----
    init = lambda k, n: jnp.sqrt(A * A + Q) * jax.random.normal(k, (n,))
    prop = lambda k, xs: A * xs + jnp.sqrt(Q) * jax.random.normal(
        k, xs.shape
    )
    ll = lambda xs, y: jax.scipy.stats.norm.logpdf(y, xs, jnp.sqrt(R))
    tl = lambda xp, xn: jax.scipy.stats.norm.logpdf(
        xn, A * xp, jnp.sqrt(Q)
    )
    run = particle_gibbs(init, prop, ll, 64, 300, trans_logpdf=tl)
    res = jax.jit(lambda k: run(k, ys))(jax.random.key(314159))
    paths = np.asarray(res.paths)[50:]

    _, mu_s, _ = kalman_smoother(ys, A, Q, R)
    print("PGAS max |mean - RTS|:",
          float(np.abs(paths.mean(0) - np.asarray(mu_s)).max()))

    # --- GFI-native: the model is a @gen Scan, no kernels -------------
    @g.gen
    def step(carry, _):
        prev = carry
        z = g.normal(A * prev, jnp.sqrt(Q)) @ "x"
        g.normal(z, jnp.sqrt(R)) @ "y"
        return z, z

    trun = trace_particle_gibbs(
        step.scan(n=T), (0.0, None), "y", ys, ("x",), 64, 300
    )
    tres = jax.jit(trun)(jax.random.key(314159))
    tpaths = np.asarray(tres.paths["x"])[50:]
    _, mu_s0, _ = kalman_smoother(ys, A, Q, R, mu0=0.0, p0=0.0)
    print("trace-PG max |mean - RTS|:",
          float(np.abs(tpaths.mean(0) - np.asarray(mu_s0)).max()))
