"""Switching linear dynamical systems (SLDS) + Rao-Blackwellized
particle filtering.

An SLDS couples a discrete Markov regime ``z_t ∈ {0..S-1}`` to a linear
Gaussian substate: ``x_t = A[z_t]·x_{t-1} + N(0, Q[z_t])``,
``y_t = x_t + N(0, R[z_t])`` (scalar substate). The exact posterior is
a Gaussian mixture with S^t components — intractable — but CONDITIONAL
on a regime path the model is a (time-varying) Kalman filter. The
Rao-Blackwellized particle filter (Doucet et al. 2000) therefore
samples only the regime path and carries each particle's exact
``(mean, variance)`` sufficient statistics analytically:

- per-particle weights are the EXACT one-step predictive
  ``p(y_t | z_{1:t}, y_{1:t-1})`` (no x-sampling noise at all), so the
  evidence estimate has strictly lower variance than a bootstrap filter
  on the joint (z, x) space — the marginalization is the whole point;
- the filter collapses to the exact Kalman filter at S=1.

Shape: one ``lax.scan`` over time; per step the whole ensemble advances
with elementwise Kalman algebra (scalar substate), regime transitions
sample by inverse-CDF compare-count against each particle's gathered
(S,) transition-CDF row (the ``models/hmm.py`` recipe), and adaptive
systematic resampling reuses ``inference.smc.resample_tree`` on the
(z, mean, var) ensemble.

New scope relative to the reference (no state-space models at all
there — SURVEY §2.2 stops at the DiscreteHMM distribution). Exact
small-T oracle: :func:`slds_exact_log_marginal` enumerates all S^T
regime paths and runs the conditional Kalman evidence on each.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.scipy.special import logsumexp

__all__ = [
    "SLDSParams",
    "simulate_slds_data",
    "slds_rbpf",
    "slds_exact_log_marginal",
]


class SLDSParams(NamedTuple):
    """Scalar-substate SLDS: per-regime dynamics/noise, regime chain."""

    trans_logits: jax.Array   # (S, S) regime transition log-probs rows
    prior_logits: jax.Array   # (S,) initial regime log-probs
    a: jax.Array              # (S,) dynamics coefficient per regime
    q: jax.Array              # (S,) process noise variance per regime
    r: jax.Array              # (S,) observation noise variance per regime
    mu0: float = 0.0          # x_0 prior mean
    p0: float = 1.0           # x_0 prior variance


class RBPFResult(NamedTuple):
    log_z: jax.Array          # evidence estimate log p(y_{1:T})
    regimes: jax.Array        # (n,) final-step regime per particle
    means: jax.Array          # (n,) final Kalman means per particle
    variances: jax.Array      # (n,) final Kalman variances per particle
    log_weights: jax.Array    # (n,) final normalized-ish log-weights
    ess_history: jax.Array    # (T,) ESS after assimilating y_t, t=0..T-1


def simulate_slds_data(key: jax.Array, params: SLDSParams, n_steps: int):
    """Sample ``(zs, xs, ys)`` from the model — the SAME generative
    convention :func:`slds_rbpf` and :func:`slds_exact_log_marginal`
    score: ``y_0`` is emitted from the PRIOR regime ``z_0`` and
    ``x_0 ~ N(mu0, p0)`` (no transition/dynamics before the first
    observation); transitions apply from ``t = 1``. ``zs[t]`` is the
    regime the filter's step-``t`` statistics condition on."""
    kz, kx, ky = jax.random.split(key, 3)

    z0 = jax.random.categorical(kz, params.prior_logits)
    x0 = params.mu0 + jnp.sqrt(params.p0) * jax.random.normal(kx)
    y0 = x0 + jnp.sqrt(params.r[z0]) * jax.random.normal(ky)

    def step(carry, ks):
        z, x = carry
        kz_t, kx_t, ky_t = ks
        z = jax.random.categorical(kz_t, params.trans_logits[z])
        x = params.a[z] * x + jnp.sqrt(params.q[z]) * jax.random.normal(
            kx_t
        )
        y = x + jnp.sqrt(params.r[z]) * jax.random.normal(ky_t)
        return (z, x), (z, x, y)

    keys = (
        jax.random.split(jax.random.fold_in(kz, 1), n_steps - 1),
        jax.random.split(jax.random.fold_in(kx, 1), n_steps - 1),
        jax.random.split(jax.random.fold_in(ky, 1), n_steps - 1),
    )
    _, (zs, xs, ys) = lax.scan(step, (z0, x0), keys)
    cat = lambda h, t: jnp.concatenate([jnp.asarray(h)[None], t])
    return cat(z0, zs), cat(x0, xs), cat(y0, ys)


def _kalman_init(mu0, p0, y, r_z):
    """Condition the ``x_0 ~ N(mu0, p0)`` prior on ``y = x_0 + noise``:
    returns the posterior ``(mu, p)`` and the predictive
    log-likelihood of ``y`` (shared by the filter and the exact
    oracle so the t=0 convention cannot diverge)."""
    s0 = p0 + r_z
    ll = -0.5 * (jnp.log(2.0 * jnp.pi * s0) + (y - mu0) ** 2 / s0)
    k0 = p0 / s0
    return mu0 + k0 * (y - mu0), (1.0 - k0) * p0, ll


def _kalman_step(mu, p, y, a_z, q_z, r_z):
    """One conditional Kalman predict+update; returns the posterior
    ``(mu, p)`` and the predictive log-likelihood of ``y``."""
    mu_pred = a_z * mu
    p_pred = a_z * a_z * p + q_z
    s = p_pred + r_z                       # innovation variance
    ll = -0.5 * (jnp.log(2.0 * jnp.pi * s) + (y - mu_pred) ** 2 / s)
    k = p_pred / s                         # Kalman gain
    mu_new = mu_pred + k * (y - mu_pred)
    p_new = (1.0 - k) * p_pred
    return mu_new, p_new, ll


def slds_rbpf(
    params: SLDSParams,
    n_particles: int,
    ess_threshold: float = 0.5,
    resampling: str = "systematic",
):
    """Build ``run(key, ys) -> RBPFResult``: Rao-Blackwellized particle
    filter over the regime path, exact Kalman statistics per particle.

    The first observation ``ys[0]`` conditions the initial regime draw
    (like ``models.hmm_bootstrap_filter``)."""
    from genjax_xla.inference.smc import (
        effective_sample_size,
        resample_tree,
    )

    s_states = params.trans_logits.shape[0]
    trans_cdf = jnp.cumsum(
        jax.nn.softmax(params.trans_logits, axis=-1), axis=-1
    )
    log_n = jnp.log(float(n_particles))

    def run(key: jax.Array, ys: jax.Array) -> RBPFResult:
        k_init, k_scan = jax.random.split(key)
        n_steps = ys.shape[0]

        # t = 0: prior regimes; x_0 prior stats updated on ys[0].
        zs = jax.random.categorical(
            k_init, params.prior_logits, shape=(n_particles,)
        )

        def p_of(z):
            return params.a[z], params.q[z], params.r[z]

        # Initial step uses the x_0 prior directly (no dynamics yet):
        # y_0 = x_0 + noise with x_0 ~ N(mu0, p0).
        r_z = params.r[zs]
        mus, ps, ll0 = _kalman_init(params.mu0, params.p0, ys[0], r_z)
        ps = ps * jnp.ones((n_particles,))
        lw = ll0
        log_z = logsumexp(lw) - log_n
        lw = lw - logsumexp(lw) + 0.0  # keep normalized-ish

        def step(carry, inp):
            t, y = inp
            zs, mus, ps, lw, log_z = carry
            k_t = jax.random.fold_in(k_scan, t)
            k_res, k_trans = jax.random.split(k_t)

            # Adaptive resampling of the FULL sufficient statistics.
            ess = effective_sample_size(lw)

            def do_resample(args):
                zs, mus, ps, lw = args
                zs, mus, ps = resample_tree(
                    k_res, lw, (zs, mus, ps), n_particles, resampling
                )
                return zs, mus, ps, jnp.zeros_like(lw)

            zs, mus, ps, lw = lax.cond(
                ess < ess_threshold * n_particles,
                do_resample,
                lambda args: args,
                (zs, mus, ps, lw),
            )

            # Regime transition by inverse CDF (one uniform/particle).
            u = jax.random.uniform(k_trans, (n_particles, 1))
            rowcdf = trans_cdf[zs]
            zs = jnp.minimum(
                jnp.sum(rowcdf < u, axis=-1), s_states - 1
            ).astype(zs.dtype)

            # Exact conditional Kalman update; the predictive
            # likelihood IS the incremental weight (Rao-Blackwell).
            a_z, q_z, r_z = p_of(zs)
            mus, ps, ll = _kalman_step(mus, ps, y, a_z, q_z, r_z)
            lw_new = lw + ll
            # Evidence increment: weighted mean predictive likelihood
            # (telescopes to the SIS evidence; resampling zeroes lw, so
            # both terms shift by log n and the increment is exact).
            log_z = log_z + logsumexp(lw_new) - logsumexp(lw)
            return (zs, mus, ps, lw_new, log_z), ess

        (zs, mus, ps, lw, log_z), ess_hist = lax.scan(
            step,
            (zs, mus, ps, lw, log_z),
            (jnp.arange(1, n_steps), ys[1:]),
        )
        # The scan's per-step ESS is measured BEFORE assimilating y_t,
        # i.e. after y_{t-1}: together with the final-weights ESS this
        # gives "ESS after assimilating y_t" for every t = 0..T-1.
        ess_hist = jnp.concatenate(
            [ess_hist, effective_sample_size(lw)[None]]
        )
        return RBPFResult(log_z, zs, mus, ps, lw, ess_hist)

    return run


def slds_exact_log_marginal(params: SLDSParams, ys: jax.Array):
    """Exact ``log p(y_{1:T})`` by enumerating all S^T regime paths and
    running the conditional Kalman evidence on each (oracle for small
    T; the grid is S^T × T so keep T ≤ ~10 at S=2)."""
    S = params.trans_logits.shape[0]
    T = ys.shape[0]
    n_paths = S**T
    # Path i's regime at time t: base-S digit t of i.
    idx = jnp.arange(n_paths)
    digits = (idx[:, None] // (S ** jnp.arange(T)[None, :])) % S  # (P, T)
    log_trans = jax.nn.log_softmax(params.trans_logits, axis=-1)
    log_prior = jax.nn.log_softmax(params.prior_logits)

    def path_logp(path):
        lp = log_prior[path[0]] + jnp.sum(
            log_trans[path[:-1], path[1:]]
        )

        # Conditional Kalman evidence along the path.
        mu, p, ll = _kalman_init(
            params.mu0, params.p0, ys[0], params.r[path[0]]
        )

        def step(carry, inp):
            mu, p, acc = carry
            z, y = inp
            mu, p, l = _kalman_step(
                mu, p, y, params.a[z], params.q[z], params.r[z]
            )
            return (mu, p, acc + l), None

        (_, _, acc), _ = lax.scan(
            step, (mu, p, ll), (path[1:], ys[1:])
        )
        return lp + acc

    lps = jax.vmap(path_logp)(digits)
    return logsumexp(lps)
