"""Oracle tests for inference/diagnostics.py (VERDICT r4 weak #6): the
R-hat / ESS estimators gate "is this chain converged" decisions, so each
is checked against closed forms — iid chains give ESS≈n and R-hat≈1,
AR(1) chains with known rho give ESS/n ≈ (1-rho)/(1+rho), split R-hat
detects both between-chain mean shifts and within-chain trends."""

import jax
import jax.numpy as jnp
import numpy as np

from genjax_xla.inference.diagnostics import (
    ess_autocorr,
    split_rhat,
    summarize,
)

KEY = jax.random.key(424242)


def _ar1(key, c, n, rho, mean=0.0):
    """AR(1) chains at stationarity: x_t = rho x_{t-1} + sqrt(1-rho^2) e_t,
    stationary N(mean, 1)."""
    e = jax.random.normal(key, (c, n))
    x0 = jax.random.normal(jax.random.fold_in(key, 1), (c,))

    def step(x, eps):
        x = rho * x + jnp.sqrt(1.0 - rho**2) * eps
        return x, x

    _, xs = jax.lax.scan(step, x0, jnp.moveaxis(e, 1, 0))
    return jnp.moveaxis(xs, 0, 1) + mean


class TestSplitRhat:
    def test_iid_chains_near_one(self):
        s = jax.random.normal(KEY, (4, 2000))
        r = float(split_rhat(s))
        assert abs(r - 1.0) < 0.02

    def test_mean_shifted_chain_detected(self):
        s = jax.random.normal(KEY, (4, 1000))
        s = s.at[0].add(3.0)  # one chain exploring a different mode
        assert float(split_rhat(s)) > 1.5

    def test_within_chain_trend_detected(self):
        """SPLIT R-hat flags nonstationarity even when every chain has
        the same trend (plain R-hat would miss this)."""
        n = 1000
        trend = jnp.linspace(-2.0, 2.0, n)
        s = jax.random.normal(KEY, (4, n)) * 0.3 + trend[None, :]
        assert float(split_rhat(s)) > 1.5

    def test_vectorizes_over_parameter_leaves(self):
        good = jax.random.normal(KEY, (4, 1000))
        bad = good + jnp.arange(4.0)[:, None] * 2.0
        s = jnp.stack([good, bad], axis=-1)  # (4, 1000, 2)
        r = np.asarray(split_rhat(s))
        assert r.shape == (2,)
        assert abs(r[0] - 1.0) < 0.05 and r[1] > 1.5


class TestEssAutocorr:
    def test_iid_ess_near_total_draws(self):
        c, n = 4, 2000
        s = jax.random.normal(KEY, (c, n))
        ess = float(ess_autocorr(s))
        assert 0.8 * c * n < ess <= 1.25 * c * n

    def test_ar1_matches_closed_form(self):
        """For AR(1) with coefficient rho, tau = (1+rho)/(1-rho), so
        ESS/N = (1-rho)/(1+rho)."""
        c, n = 8, 8000
        for rho, tol in ((0.5, 0.15), (0.8, 0.2)):
            s = _ar1(jax.random.fold_in(KEY, int(rho * 10)), c, n, rho)
            ratio = float(ess_autocorr(s)) / (c * n)
            expect = (1.0 - rho) / (1.0 + rho)
            assert abs(ratio - expect) / expect < tol, (rho, ratio, expect)

    def test_anticorrelated_ess_exceeds_n(self):
        """Negative lag-1 autocorrelation is super-efficient: ESS > N
        (the Geyer truncation must not clip the negative rho_1)."""
        s = _ar1(KEY, 4, 4000, -0.5)
        assert float(ess_autocorr(s)) > 1.5 * 4 * 4000

    def test_explicit_max_lag(self):
        s = jax.random.normal(KEY, (2, 500))
        e1 = float(ess_autocorr(s, max_lag=50))
        assert 0.7 * 1000 < e1 < 1.4 * 1000

    def test_vectorizes_over_parameter_leaves(self):
        """(chains, draws, d) input gives a (d,) ESS with per-component
        truncation — the iid component must not inherit the sticky
        component's cutoff."""
        c, n = 4, 4000
        iid = jax.random.normal(KEY, (c, n))
        sticky = _ar1(jax.random.fold_in(KEY, 9), c, n, 0.8)
        s = jnp.stack([iid, sticky], axis=-1)
        ess = np.asarray(ess_autocorr(s))
        assert ess.shape == (2,)
        assert ess[0] > 0.7 * c * n
        expect = c * n * (1.0 - 0.8) / (1.0 + 0.8)
        assert abs(ess[1] - expect) / expect < 0.25
        # Consistency with the per-component computation.
        np.testing.assert_allclose(
            ess[1], float(ess_autocorr(s[..., 1])), rtol=1e-5
        )

    def test_jit_and_static_shapes(self):
        s = jax.random.normal(KEY, (4, 1000))
        a = float(jax.jit(ess_autocorr)(s))
        b = float(ess_autocorr(s))
        np.testing.assert_allclose(a, b, rtol=1e-6)


class TestSummarize:
    def test_keys_and_moments(self):
        s = 2.0 + 0.5 * jax.random.normal(KEY, (4, 2000))
        out = summarize(s)
        assert set(out) == {"mean", "std", "rhat", "ess"}
        assert abs(float(out["mean"]) - 2.0) < 0.03
        assert abs(float(out["std"]) - 0.5) < 0.03
        assert abs(float(out["rhat"]) - 1.0) < 0.02
        assert float(out["ess"]) > 0.7 * 8000

    def test_multidim(self):
        s = jax.random.normal(KEY, (4, 1000, 3))
        out = summarize(s)
        for k in ("mean", "std", "rhat", "ess"):
            assert np.asarray(out[k]).shape == (3,), k


class TestShortChains:
    def test_two_draws_no_crash(self):
        """Review r5: n<=2 has no estimable autocorrelation — tau=1."""
        s = jax.random.normal(KEY, (4, 2))
        assert float(ess_autocorr(s)) == 8.0
        out = summarize(s)
        assert float(out["ess"]) == 8.0

    def test_explicit_zero_max_lag(self):
        s = jax.random.normal(KEY, (4, 100, 2))
        e = np.asarray(ess_autocorr(s, max_lag=0))
        np.testing.assert_array_equal(e, np.full(2, 400.0))
