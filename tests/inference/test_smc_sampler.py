"""Tempered-SMC tests: logZ vs exact conjugate marginals, posterior moment
recovery, and HMC-rejuvenated variant."""

import jax
import jax.numpy as jnp
import numpy as np

import genjax_xla as g
from genjax_xla.inference import HMC, Target
from genjax_xla.inference.smc_sampler import tempered_smc

KEY = jax.random.key(314159)


@g.gen
def conjugate(obs_std):
    mu = g.normal(0.0, 1.0) @ "mu"
    _ = g.normal(mu, obs_std) @ "y"


def make_target(y=1.0, obs_std=0.5):
    return Target(conjugate, (obs_std,), g.C["y"].set(y))


def exact_logz(y=1.0, obs_std=0.5):
    # marginal of y: N(0, 1 + obs_std^2)
    from scipy.stats import norm

    return norm(0.0, np.sqrt(1 + obs_std**2)).logpdf(y)


class TestTemperedSMC:
    def test_logz_matches_exact(self):
        run = tempered_smc(make_target(), 2048, n_temps=20, n_moves=2)
        result = jax.jit(run)(KEY)
        np.testing.assert_allclose(
            float(result.log_z), exact_logz(), atol=0.05
        )

    def test_posterior_moments(self):
        run = tempered_smc(make_target(), 4096, n_temps=20, n_moves=3)
        result = jax.jit(run)(KEY)
        mus = np.asarray(result.traces.get_choices()["mu"])
        w = np.asarray(jax.nn.softmax(result.log_weights))
        post_mean = 1.0 / (1 + 0.25)
        post_std = np.sqrt(0.25 / 1.25)
        assert abs((w * mus).sum() - post_mean) < 0.05
        assert abs(np.sqrt((w * (mus - (w * mus).sum()) ** 2).sum())
                   - post_std) < 0.05

    def test_acceptance_rates_reasonable(self):
        run = tempered_smc(make_target(), 1024, n_temps=10, n_moves=1)
        result = jax.jit(run)(KEY)
        # Prior-proposal regenerate at low beta accepts nearly always.
        assert float(result.accept_rate[0]) > 0.5
        assert float(result.accept_rate.mean()) > 0.2

    def test_hmc_rejuvenation(self):
        run = tempered_smc(
            make_target(), 512, n_temps=10,
            make_request=lambda: HMC(g.S.at["mu"], 0.2, 5),
            n_moves=1,
        )
        result = jax.jit(run)(KEY)
        np.testing.assert_allclose(
            float(result.log_z), exact_logz(), atol=0.1
        )
        # HMC at these scales should accept most moves.
        assert float(result.accept_rate.mean()) > 0.6


class TestWasteFree:
    def test_waste_free_logz_and_posterior(self):
        from genjax_xla.inference.smc_sampler import waste_free_tempered_smc

        run = waste_free_tempered_smc(
            make_target(), n_resampled=128, n_moves_per_particle=8,
            n_temps=15,
        )
        result = jax.jit(run)(KEY)
        np.testing.assert_allclose(
            float(result.log_z), exact_logz(), atol=0.08
        )
        mus = np.asarray(result.traces.get_choices()["mu"])
        assert mus.shape == (1024,)
        post_mean = 1.0 / 1.25
        w = np.asarray(jax.nn.softmax(result.log_weights))
        assert abs((w * mus).sum() - post_mean) < 0.05

    def test_waste_free_hmc(self):
        from genjax_xla.inference.smc_sampler import waste_free_tempered_smc

        run = waste_free_tempered_smc(
            make_target(), n_resampled=64, n_moves_per_particle=4,
            n_temps=10,
            make_request=lambda: HMC(g.S.at["mu"], 0.25, 5),
        )
        result = jax.jit(run)(KEY)
        np.testing.assert_allclose(
            float(result.log_z), exact_logz(), atol=0.15
        )
        assert float(result.accept_rate.mean()) > 0.5


class TestAIS:
    """annealed_importance_sampling = tempered_smc with the resample
    gate statically off: unbiased evidence, independent particles."""

    def test_logz_matches_conjugate_evidence(self):
        import genjax_xla as g
        from genjax_xla.inference import annealed_importance_sampling

        @g.gen
        def model():
            mu = g.normal(0.0, 1.0) @ "mu"
            _ = g.normal(mu, 0.5) @ "y"

        y = 1.0
        target = Target(model, (), g.C["y"].set(y))
        # Exact evidence: N(y; 0, 1 + 0.25).
        from jax.scipy.stats import norm

        exact = float(norm.logpdf(y, 0.0, jnp.sqrt(1.25)))
        run = annealed_importance_sampling(
            target, n_particles=512, n_temps=16, n_moves=2
        )
        res = jax.jit(run)(jax.random.key(4))
        assert abs(float(res.log_z) - exact) < 0.05
        # Weights are non-degenerate (independent runs, no resampling).
        lw = np.asarray(res.log_weights)
        assert np.isfinite(lw).all()
        ess = np.exp(2 * np.log(np.exp(lw - lw.max()).sum())
                     - np.log((np.exp(lw - lw.max()) ** 2).sum()))
        assert ess > 64

    def test_bitwise_equals_tempered_with_zero_threshold(self):
        import genjax_xla as g
        from genjax_xla.inference import (
            annealed_importance_sampling,
            tempered_smc,
        )

        @g.gen
        def model():
            mu = g.normal(0.0, 1.0) @ "mu"
            _ = g.normal(mu, 0.5) @ "y"

        target = Target(model, (), g.C["y"].set(0.3))
        a = jax.jit(annealed_importance_sampling(target, 64, n_temps=6))(
            jax.random.key(5)
        )
        b = jax.jit(tempered_smc(target, 64, n_temps=6,
                                 ess_threshold=0.0))(jax.random.key(5))
        assert np.array_equal(np.asarray(a.log_z), np.asarray(b.log_z))
        assert np.array_equal(
            np.asarray(a.log_weights), np.asarray(b.log_weights)
        )

    def test_zero_threshold_never_builds_resample(self, monkeypatch):
        """ADVICE r4: ``ess_threshold=0`` must statically elide the
        resample branch — not merely never take it at runtime. Stub the
        resampler to explode if it is ever traced: AIS tracing succeeds,
        the adaptive sampler's tracing hits the stub."""
        import pytest

        import genjax_xla as g
        from genjax_xla.inference import (
            annealed_importance_sampling,
            smc_sampler,
            tempered_smc,
        )

        @g.gen
        def model():
            mu = g.normal(0.0, 1.0) @ "mu"
            _ = g.normal(mu, 0.5) @ "y"

        target = Target(model, (), g.C["y"].set(0.3))

        def boom(*a, **k):
            raise AssertionError("resample_tree was traced")

        monkeypatch.setattr(smc_sampler, "resample_tree", boom)
        # AIS: the resample cond is never built, so tracing never calls
        # the stub.
        jax.make_jaxpr(
            annealed_importance_sampling(target, 16, n_temps=3)
        )(jax.random.key(0))
        # Adaptive: the cond IS built — tracing must hit the stub.
        with pytest.raises(AssertionError, match="resample_tree"):
            jax.make_jaxpr(
                tempered_smc(target, 16, n_temps=3, ess_threshold=0.5)
            )(jax.random.key(0))
