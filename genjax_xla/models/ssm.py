"""State-space model families: linear-Gaussian (with exact Kalman oracle)
and the benchmark nonlinear tracking model."""

from __future__ import annotations

import jax
import jax.numpy as jnp

from genjax_xla.lang.static import gen
from genjax_xla.lang.distributions import normal

__all__ = ["lgssm_model", "kalman_filter", "kalman_smoother",
           "simulate_lgssm_data", "lgssm_grid_posterior",
           "nonlinear_tracking_model"]


def simulate_lgssm_data(key, a, q, r, n_steps, mu0=0.0):
    """Sample ``(xs, ys)`` from the 1-D LGSSM ``x_t = a·x_{t-1} +
    N(0, q)``, ``y_t = x_t + N(0, r)`` with ``x_0 = mu0`` — the shared
    synthetic-data generator for the PMMH / SMC² / particle-Gibbs
    tests, benchmarks, and examples (its exact marginal likelihood is
    :func:`kalman_filter` with ``p0=0``)."""
    kx, ky = jax.random.split(key)
    ex = jnp.sqrt(q) * jax.random.normal(kx, (n_steps,))
    ey = jnp.sqrt(r) * jax.random.normal(ky, (n_steps,))

    def step(x, e):
        x = a * x + e
        return x, x

    _, xs = jax.lax.scan(step, jnp.asarray(mu0), ex)
    return xs, xs + ey


def lgssm_grid_posterior(ys, q, r, grid, log_prior_density=None):
    """Exact quadrature posterior over the transition coefficient of
    the LGSSM above: returns ``(mean, std, log_evidence)``. The exact
    per-point marginal likelihood comes from :func:`kalman_filter`
    (``mu0=0, p0=0``); ``log_prior_density``: callable of ``a``
    (default: uniform over the grid span)."""
    lls = jax.vmap(
        lambda a: kalman_filter(ys, a, q, r, mu0=0.0, p0=0.0)[0]
    )(grid)
    span = grid[-1] - grid[0]
    lp = (
        -jnp.log(span) * jnp.ones_like(grid)
        if log_prior_density is None
        else jax.vmap(log_prior_density)(grid)
    )
    post = lls + lp
    w = jnp.exp(post - jnp.max(post))
    w = w / jnp.sum(w)
    mean = jnp.sum(grid * w)
    std = jnp.sqrt(jnp.sum((grid - mean) ** 2 * w))
    da = grid[1] - grid[0]
    log_ev = jax.scipy.special.logsumexp(post) + jnp.log(da)
    return mean, std, log_ev


def lgssm_model(a: float, q: float, r: float, n_steps: int):
    """1-D linear-Gaussian SSM as a scanned gen fn:
    x_t = a·x_{t-1} + N(0, q);  y_t = x_t + N(0, r).
    Latents at ``(t, "x")``, observations at ``(t, "y")``."""

    @gen
    def step(carry, _):
        x_prev = carry
        x = normal(a * x_prev, jnp.sqrt(q)) @ "x"
        _ = normal(x, jnp.sqrt(r)) @ "y"
        return x, x

    return step.scan(n=n_steps)


def kalman_filter(ys, a, q, r, mu0=0.0, p0=1.0):
    """Exact log-likelihood + filtered means for the 1-D LGSSM where the
    first latent is x_1 ~ N(a·mu0, a²p0 + q)."""

    def step(carry, y):
        mu, p, ll = carry
        # predict
        mu, p = a * mu, a * a * p + q
        # update
        s = p + r
        ll = ll - 0.5 * (jnp.log(2 * jnp.pi * s) + (y - mu) ** 2 / s)
        k_gain = p / s
        mu = mu + k_gain * (y - mu)
        p = (1 - k_gain) * p
        return (mu, p, ll), mu

    (mu, p, ll), mus = jax.lax.scan(
        step, (jnp.asarray(mu0), jnp.asarray(p0), jnp.zeros(())), ys
    )
    return ll, mus


def kalman_smoother(ys, a, q, r, mu0=0.0, p0=1.0):
    """Exact RTS smoother for the same 1-D LGSSM as
    :func:`kalman_filter`: returns ``(log_lik, smoothed_means,
    smoothed_vars)`` — the oracle for particle-Gibbs / FFBS tests."""

    def fstep(carry, y):
        mu, p, ll = carry
        mu_pred, p_pred = a * mu, a * a * p + q
        s = p_pred + r
        ll = ll - 0.5 * (jnp.log(2 * jnp.pi * s) + (y - mu_pred) ** 2 / s)
        k_gain = p_pred / s
        mu_f = mu_pred + k_gain * (y - mu_pred)
        p_f = (1 - k_gain) * p_pred
        return (mu_f, p_f, ll), (mu_f, p_f, mu_pred, p_pred)

    (_, _, ll), (mu_f, p_f, mu_pred, p_pred) = jax.lax.scan(
        fstep, (jnp.asarray(mu0), jnp.asarray(p0), jnp.zeros(())), ys
    )

    def bstep(carry, inp):
        mu_next, p_next = carry
        mu_ft, p_ft, mu_pn, p_pn = inp
        c = p_ft * a / p_pn
        mu_s = mu_ft + c * (mu_next - mu_pn)
        p_s = p_ft + c * c * (p_next - p_pn)
        return (mu_s, p_s), (mu_s, p_s)

    # Backward pass over t = T-1 .. 1, seeded by the final filtered
    # state; inputs pair filtered t with predicted t+1.
    init = (mu_f[-1], p_f[-1])
    _, (mu_s_rev, p_s_rev) = jax.lax.scan(
        bstep, init,
        (mu_f[:-1][::-1], p_f[:-1][::-1],
         mu_pred[1:][::-1], p_pred[1:][::-1]),
    )
    mu_s = jnp.concatenate([mu_s_rev[::-1], mu_f[-1:]])
    p_s = jnp.concatenate([p_s_rev[::-1], p_f[-1:]])
    return ll, mu_s, p_s


def nonlinear_tracking_model():
    """The classic nonlinear benchmark (Gordon et al. 1993):
    x_t = x/2 + 25x/(1+x²) + N(0,10);  y_t = x²/20 + N(0,1).
    Returns ``(init, step)`` callables for ``particle_filter``."""

    def init(key):
        return jax.random.normal(key), jnp.zeros(())

    def step(key, x, y):
        x_new = (
            0.5 * x + 25.0 * x / (1.0 + x * x)
            + jnp.sqrt(10.0) * jax.random.normal(key)
        )
        lw = jax.scipy.stats.norm.logpdf(y, x_new * x_new / 20.0, 1.0)
        return x_new, lw

    return init, step
