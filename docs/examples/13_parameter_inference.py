"""Parameter inference for state-space models: PMMH (pseudo-marginal
MCMC) and SMC² (sequential), both checked against exact Kalman-grid
quadrature."""

import jax
import jax.numpy as jnp
import numpy as np

from genjax_xla.inference import particle_filter, pmmh, smc2
from genjax_xla.models import lgssm_grid_posterior, simulate_lgssm_data

if __name__ == "__main__":
    A_TRUE, Q, R, T = 0.7, 0.4, 0.4, 50
    _, ys = simulate_lgssm_data(jax.random.key(11), A_TRUE, Q, R, T)

    mean, std, log_ev = lgssm_grid_posterior(
        ys, Q, R, jnp.linspace(-0.949, 0.949, 191)
    )
    print(f"exact posterior over a: mean {float(mean):.3f} "
          f"std {float(std):.3f}; log evidence {float(log_ev):.2f}")

    # --- PMMH: random-walk MH over a, PF logZ as the likelihood -------
    def log_marginal(key, a):
        def init(k):
            x = jnp.sqrt(Q) * jax.random.normal(k, (512,))
            return x, jax.scipy.stats.norm.logpdf(ys[0], x, jnp.sqrt(R))

        def step(k, xs, y):
            xs = a * xs + jnp.sqrt(Q) * jax.random.normal(k, xs.shape)
            return xs, jax.scipy.stats.norm.logpdf(y, xs, jnp.sqrt(R))

        final, _ = particle_filter(init, step, 512, batched=True)(
            key, ys[1:]
        )
        return final.log_z

    log_prior = lambda a: jnp.where(jnp.abs(a) < 0.95, 0.0, -jnp.inf)
    run = pmmh(log_marginal, log_prior, n_iters=2000, proposal=0.08)
    res = jax.jit(lambda k: run(k, jnp.asarray(0.0)))(jax.random.key(0))
    chain = np.asarray(res.thetas)[400:]
    print(f"PMMH: mean {chain.mean():.3f} std {chain.std():.3f} "
          f"(accept {float(res.accept_rate):.2f})")

    # --- SMC²: sequential joint parameter+state inference --------------
    run2 = smc2(
        lambda key, a, n: jnp.sqrt(Q) * jax.random.normal(key, (n,)),
        lambda key, a, xs: a * xs
        + jnp.sqrt(Q) * jax.random.normal(key, xs.shape),
        lambda a, xs, y: jax.scipy.stats.norm.logpdf(y, xs, jnp.sqrt(R)),
        lambda key: jax.random.uniform(key, minval=-0.95, maxval=0.95),
        lambda a: jnp.where(jnp.abs(a) < 0.95, -jnp.log(1.9), -jnp.inf),
        n_theta=256, n_x=128, proposal=0.15,
    )
    r2 = jax.jit(lambda k: run2(k, ys))(jax.random.key(1))
    w = np.exp(np.asarray(r2.log_weights)
               - np.asarray(r2.log_weights).max())
    w /= w.sum()
    th = np.asarray(r2.thetas)
    m2 = float((th * w).sum())
    print(f"SMC2: mean {m2:.3f}; log evidence {float(r2.log_z):.2f} "
          f"(rejuvenation accept {float(r2.rejuv_accept):.2f})")
