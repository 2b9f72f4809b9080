"""SMC² vs exact quadrature: for a 1-D LGSSM with unknown transition
coefficient, the Kalman filter gives p(y | a) exactly, so both the
parameter posterior p(a | y) and the evidence p(y) = ∫ p(y|a)p(a) da
are grid-computable oracles."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from genjax_xla.inference.smc2 import smc2
from genjax_xla.models.ssm import (
    lgssm_grid_posterior,
    simulate_lgssm_data,
)

A_TRUE, Q, R, T = 0.7, 0.4, 0.4, 50
KEY = jax.random.key(314159)


YS = simulate_lgssm_data(jax.random.key(11), A_TRUE, Q, R, T)[1]


def _model():
    init = lambda key, a, n: jnp.sqrt(Q) * jax.random.normal(key, (n,))
    prop = lambda key, a, xs: a * xs + jnp.sqrt(Q) * jax.random.normal(
        key, xs.shape
    )
    ll = lambda a, xs, y: jax.scipy.stats.norm.logpdf(
        y, xs, jnp.sqrt(R)
    )
    prior_sample = lambda key: jax.random.uniform(
        key, minval=-0.95, maxval=0.95
    )
    log_prior = lambda a: jnp.where(
        jnp.abs(a) < 0.95, -jnp.log(1.9), -jnp.inf
    )
    return init, prop, ll, prior_sample, log_prior


def _grid_oracle():
    mean, std, log_ev = lgssm_grid_posterior(
        YS, Q, R, jnp.linspace(-0.949, 0.949, 191)
    )
    return float(mean), float(std), float(log_ev)


class TestSMC2:
    def test_posterior_and_evidence_match_quadrature(self):
        init, prop, ll, prior_sample, log_prior = _model()
        run = smc2(init, prop, ll, prior_sample, log_prior,
                   n_theta=512, n_x=128, proposal=0.15)
        res = jax.jit(lambda k: run(k, YS))(KEY)
        mean, std, log_ev = _grid_oracle()

        w = np.exp(np.asarray(res.log_weights)
                   - np.max(np.asarray(res.log_weights)))
        w = w / w.sum()
        th = np.asarray(res.thetas)
        got_mean = float((th * w).sum())
        got_std = float(np.sqrt(((th - got_mean) ** 2 * w).sum()))
        assert abs(got_mean - mean) < 0.06, (got_mean, mean)
        assert abs(got_std - std) < 0.06, (got_std, std)
        assert abs(float(res.log_z) - log_ev) < 1.0, (
            float(res.log_z), log_ev,
        )
        # rejuvenation fired and moved
        assert float(res.rejuv_accept) > 0.05
        assert np.asarray(res.ess_history).min() < 512

    def test_jit_and_shapes(self):
        init, prop, ll, prior_sample, log_prior = _model()
        run = smc2(init, prop, ll, prior_sample, log_prior,
                   n_theta=32, n_x=16, proposal=0.2)
        res = jax.jit(lambda k: run(k, YS[:10]))(jax.random.key(1))
        assert res.thetas.shape == (32,)
        assert res.log_weights.shape == (32,)
        assert res.ess_history.shape == (9,)
        assert jnp.isfinite(res.log_z)

    @pytest.mark.parametrize(
        "method", ["systematic", "stratified", "multinomial"]
    )
    def test_inner_methods_match_quadrature(self, method):
        """Every inner resampling scheme recovers the grid oracle (at a
        second seed for the systematic default)."""
        init, prop, ll, prior_sample, log_prior = _model()
        run = smc2(init, prop, ll, prior_sample, log_prior,
                   n_theta=512, n_x=128, proposal=0.15,
                   inner_resampling=method)
        res = jax.jit(lambda k: run(k, YS))(jax.random.key(5))
        mean, std, log_ev = _grid_oracle()
        w = np.exp(np.asarray(res.log_weights)
                   - np.max(np.asarray(res.log_weights)))
        w = w / w.sum()
        th = np.asarray(res.thetas)
        got_mean = float((th * w).sum())
        assert abs(got_mean - mean) < 0.06, (got_mean, mean)
        assert abs(float(res.log_z) - log_ev) < 1.0, (
            float(res.log_z), log_ev,
        )

    def test_bad_inner_resampling_raises(self):
        init, prop, ll, prior_sample, log_prior = _model()
        with pytest.raises(ValueError, match="Unknown resampling method"):
            smc2(init, prop, ll, prior_sample, log_prior,
                 n_theta=8, n_x=8, inner_resampling="nope")
