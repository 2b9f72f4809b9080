"""Particle-filter tests: logZ vs exact Kalman filter on a linear-Gaussian
state-space model, HMM data marginal vs FFBS, and nonlinear 1D tracking
(benchmark config 4 shape)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import genjax_xla as g
from genjax_xla.inference.pf import bootstrap_filter, particle_filter
from genjax_xla.lang.distributions.discrete_hmm import (
    DiscreteHMMConfiguration,
    forward_filter,
)

KEY = jax.random.key(314159)


def kalman_loglik(ys, a, q, r, mu0, p0):
    """Exact log-likelihood of a 1D linear-Gaussian SSM via Kalman."""
    ll = 0.0
    mu, p = mu0, p0
    for y in ys:
        # predict already included in (mu, p) for t=0
        s = p + r
        ll += -0.5 * (np.log(2 * np.pi * s) + (y - mu) ** 2 / s)
        k_gain = p / s
        mu = mu + k_gain * (y - mu)
        p = (1 - k_gain) * p
        mu, p = a * mu, a * a * p + q
    return ll


class TestLinearGaussian:
    def test_logz_matches_kalman(self):
        a, q, r = 0.9, 0.5, 0.3
        rng = np.random.default_rng(0)
        T = 15
        x = rng.normal(0, 1)
        ys = []
        for _ in range(T):
            ys.append(x + rng.normal(0, np.sqrt(r)))
            x = a * x + rng.normal(0, np.sqrt(q))
        ys = jnp.asarray(ys)
        want = kalman_loglik(np.asarray(ys), a, q, r, 0.0, 1.0)

        def init(key):
            x0 = jax.random.normal(key)
            lw = jax.scipy.stats.norm.logpdf(ys[0], x0, np.sqrt(r))
            return (x0, jnp.asarray(0)), lw

        def step(key, state, y):
            x, t = state
            x_new = a * x + jnp.sqrt(q) * jax.random.normal(key)
            lw = jax.scipy.stats.norm.logpdf(y, x_new, np.sqrt(r))
            return (x_new, t + 1), lw

        # obs stream shifted: init consumes ys[0], steps consume ys[1:].
        pf = particle_filter(init, step, n_particles=20_000)
        final, log_zs = jax.jit(lambda k: pf(k, ys[1:]))(KEY)
        got = float(final.log_z)
        np.testing.assert_allclose(got, want, atol=0.1)

    def test_no_resampling_path_unbiased(self):
        """With threshold 0 (never resample), the filter reduces to
        sequential importance sampling; logZ must still be unbiased."""
        a, q, r = 0.9, 0.5, 0.3
        ys = jnp.asarray([0.3, -0.2, 0.5])
        want = kalman_loglik(np.asarray(ys), a, q, r, 0.0, 1.0)

        def init(key):
            x0 = jax.random.normal(key)
            return x0, jax.scipy.stats.norm.logpdf(ys[0], x0, np.sqrt(r))

        def step(key, x, y):
            x_new = a * x + jnp.sqrt(q) * jax.random.normal(key)
            return x_new, jax.scipy.stats.norm.logpdf(y, x_new, np.sqrt(r))

        pf = particle_filter(init, step, 50_000, ess_threshold=0.0)
        final, _ = jax.jit(lambda k: pf(k, ys[1:]))(KEY)
        np.testing.assert_allclose(float(final.log_z), want, atol=0.05)


class TestHMM:
    def test_logz_matches_ffbs(self):
        config = DiscreteHMMConfiguration.circulant(5, 5)
        obs = jax.random.randint(jax.random.key(3), (12,), 0, 5)
        _, want = forward_filter(config, obs)

        def init(key):
            z = jax.random.categorical(key, config.prior_logits)
            return z, config.observation_logits[z, obs[0]]

        def step(key, z, o):
            z_new = jax.random.categorical(
                key, config.transition_logits[z]
            )
            return z_new, config.observation_logits[z_new, o]

        pf = particle_filter(init, step, 8192)
        final, _ = jax.jit(lambda k: pf(k, obs[1:]))(KEY)
        np.testing.assert_allclose(float(final.log_z), float(want),
                                   atol=0.05)


class TestBootstrapGFI:
    def test_bootstrap_from_gen_fns(self):
        @g.gen
        def prior():
            return g.normal(0.0, 1.0) @ "x"

        @g.gen
        def transition(x):
            return g.normal(0.9 * x, jnp.sqrt(0.5)) @ "x"

        def obs_logpdf(x, y):
            return jax.scipy.stats.norm.logpdf(y, x, jnp.sqrt(0.3))

        ys = jnp.asarray([0.3, -0.2, 0.5, 0.1])
        pf = bootstrap_filter(
            transition, obs_logpdf, 4096, init_prior=prior
        )

        # Note: init gives weight 0 (no obs at t=0 for this variant);
        # all observations are consumed by the steps.
        final, log_zs = jax.jit(lambda k: pf(k, ys))(KEY)
        want = kalman_loglik(
            np.asarray(ys), 0.9, 0.5, 0.3,
            0.0, 0.9**2 * 1.0 + 0.5,
        )
        # The model's first observed state is transition(prior), so the
        # Kalman recursion starts from the predicted distribution.
        np.testing.assert_allclose(float(final.log_z), want, atol=0.1)


class TestNonlinearTracking:
    def test_1d_tracking_runs(self):
        """Nonlinear dynamics + tanh observation: sanity + determinism."""

        def init(key):
            return jax.random.normal(key), jnp.zeros(())

        def step(key, x, y):
            x_new = (
                0.5 * x + 25.0 * x / (1.0 + x * x)
                + jnp.sqrt(10.0) * jax.random.normal(key)
            )
            lw = jax.scipy.stats.norm.logpdf(
                y, x_new * x_new / 20.0, 1.0
            )
            return x_new, lw

        ys = jax.random.normal(jax.random.key(9), (30,)) * 5.0
        pf = particle_filter(init, step, 4096)
        f1, _ = jax.jit(lambda k: pf(k, ys))(KEY)
        f2, _ = jax.jit(lambda k: pf(k, ys))(KEY)
        assert bool(jnp.isfinite(f1.log_z))
        assert float(f1.log_z) == float(f2.log_z)
        ess = float(
            jnp.exp(
                -jax.scipy.special.logsumexp(
                    2 * (f1.log_weights
                         - jax.scipy.special.logsumexp(f1.log_weights))
                )
            )
        )
        assert ess > 1.0


def test_resample_tree_invariant_upsample_guard():
    from genjax_xla.inference.smc import resample_tree

    tree = (jnp.zeros((4, 2)), jnp.zeros((4, 3)))
    with pytest.raises(ValueError, match="invariant leaf"):
        resample_tree(
            jax.random.key(0), jnp.zeros(4), tree, 8,
            invariant=(True, False),
        )
