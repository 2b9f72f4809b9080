"""Tests for the long-tail distributions (beta_quotient, lambert_w_normal,
power_spherical, von_mises_fisher) and the special functions backing them.
Self-validating: normalization integrals, MC histograms vs density, and
scipy oracles where available."""

import jax
import jax.numpy as jnp
import numpy as np
import scipy.special as sps

import genjax_xla as g
from genjax_xla.lang.distributions.special import lambertw, log_bessel_iv

KEY = jax.random.key(314159)


class TestSpecial:
    def test_lambertw_inverts(self):
        xs = jnp.array([0.0, 0.1, 1.0, 5.0, 100.0, 1e4])
        w = lambertw(xs)
        np.testing.assert_allclose(
            np.asarray(w * jnp.exp(w)), np.asarray(xs), rtol=1e-5
        )

    def test_lambertw_vs_scipy(self):
        xs = np.linspace(0.01, 50.0, 20)
        want = np.real(sps.lambertw(xs))
        np.testing.assert_allclose(
            np.asarray(lambertw(jnp.asarray(xs))), want, rtol=1e-5
        )

    def test_log_bessel_iv_vs_scipy(self):
        for v in [0.5, 1.0, 2.5, 10.0]:
            for x in [0.1, 1.0, 5.0, 30.0, 200.0]:
                want = np.log(sps.ive(v, x)) + x
                got = float(log_bessel_iv(v, jnp.asarray(x)))
                np.testing.assert_allclose(got, want, rtol=2e-3,
                                           err_msg=f"v={v} x={x}")


class TestBetaQuotient:
    def test_normalizes(self):
        # Dense grid near 0 where mass concentrates, sparse tail.
        grid = jnp.concatenate([
            jnp.linspace(1e-4, 5.0, 20001),
            jnp.linspace(5.0, 60.0, 2000)[1:],
        ])
        lp = jax.vmap(
            lambda t: g.beta_quotient.logpdf(t, 2.0, 3.0, 4.0, 3.0)
        )(grid)
        integral = float(jnp.trapezoid(jnp.exp(lp), grid))
        np.testing.assert_allclose(integral, 1.0, atol=2e-2)

    def test_histogram_matches_density(self):
        keys = jax.random.split(KEY, 40000)
        xs = np.asarray(
            jax.vmap(
                lambda k: g.beta_quotient.sample(k, 2.0, 3.0, 4.0, 3.0)
            )(keys)
        )
        # Compare CDF at a few points.
        for t in [0.25, 0.5, 1.0, 2.0]:
            grid = jnp.linspace(1e-4, t, 4001)
            lp = jax.vmap(
                lambda u: g.beta_quotient.logpdf(u, 2.0, 3.0, 4.0, 3.0)
            )(grid)
            cdf = float(jnp.trapezoid(jnp.exp(lp), grid))
            emp = float(np.mean(xs <= t))
            assert abs(cdf - emp) < 0.02, (t, cdf, emp)


class TestLambertWNormal:
    def test_reduces_to_normal_at_zero_tail(self):
        lp = g.lambert_w_normal.logpdf(0.7, 0.0, 1.0, 1e-8)
        want = jax.scipy.stats.norm.logpdf(0.7)
        np.testing.assert_allclose(float(lp), float(want), atol=1e-4)

    def test_normalizes(self):
        grid = jnp.linspace(-60.0, 60.0, 200001)
        lp = jax.vmap(
            lambda y: g.lambert_w_normal.logpdf(y, 0.5, 1.5, 0.2)
        )(grid)
        integral = float(jnp.trapezoid(jnp.exp(lp), grid))
        np.testing.assert_allclose(integral, 1.0, atol=1e-2)

    def test_sample_quantiles(self):
        keys = jax.random.split(KEY, 40000)
        ys = np.asarray(
            jax.vmap(
                lambda k: g.lambert_w_normal.sample(k, 0.0, 1.0, 0.3)
            )(keys)
        )
        # Median is loc (transform is sign-symmetric).
        assert abs(np.median(ys)) < 0.02


class TestPowerSpherical:
    def test_unit_norm_and_mean_direction(self):
        mu = jnp.array([0.0, 0.0, 1.0])
        keys = jax.random.split(KEY, 5000)
        xs = np.asarray(
            jax.vmap(lambda k: g.power_spherical.sample(k, mu, 10.0))(keys)
        )
        np.testing.assert_allclose(
            np.linalg.norm(xs, axis=1), 1.0, atol=1e-5
        )
        mean_dir = xs.mean(0) / np.linalg.norm(xs.mean(0))
        assert mean_dir @ np.asarray(mu) > 0.99

    def test_normalizes_on_circle(self):
        # d=2: integrate over angle.
        mu = jnp.array([1.0, 0.0])
        thetas = jnp.linspace(-jnp.pi, jnp.pi, 20001)
        xs = jnp.stack([jnp.cos(thetas), jnp.sin(thetas)], axis=-1)
        lp = jax.vmap(lambda x: g.power_spherical.logpdf(x, mu, 3.0))(xs)
        integral = float(jnp.trapezoid(jnp.exp(lp), thetas))
        np.testing.assert_allclose(integral, 1.0, atol=1e-3)

    def test_marginal_t_matches_beta(self):
        """mu.x ~ 2*Beta(alpha, beta) - 1 by construction."""
        mu = jnp.array([1.0, 0.0, 0.0])
        conc = 4.0
        keys = jax.random.split(KEY, 20000)
        xs = np.asarray(
            jax.vmap(lambda k: g.power_spherical.sample(k, mu, conc))(keys)
        )
        t = xs[:, 0]
        alpha, beta_ = 1.0 + conc, 1.0
        want_mean = 2 * alpha / (alpha + beta_) - 1
        np.testing.assert_allclose(t.mean(), want_mean, atol=0.01)


class TestVonMisesFisher:
    def test_unit_norm_and_concentration(self):
        mu = jnp.array([0.0, 1.0, 0.0])
        keys = jax.random.split(KEY, 5000)
        xs = np.asarray(
            jax.vmap(lambda k: g.von_mises_fisher.sample(k, mu, 5.0))(keys)
        )
        np.testing.assert_allclose(
            np.linalg.norm(xs, axis=1), 1.0, atol=1e-5
        )
        # E[mu.x] = coth(k) - 1/k for d=3.
        k = 5.0
        want = 1.0 / np.tanh(k) - 1.0 / k
        np.testing.assert_allclose(
            (xs @ np.asarray(mu)).mean(), want, atol=0.01
        )

    def test_logpdf_normalizes_d3(self):
        """Integrate over the sphere: E_uniform[p] * 4pi = 1."""
        mu = jnp.array([0.0, 0.0, 1.0])
        conc = 2.0
        # closed form for d=3: C = k / (4 pi sinh k)
        t = jnp.linspace(-1.0, 1.0, 20001)
        x = jnp.stack(
            [jnp.sqrt(1 - t * t), jnp.zeros_like(t), t], axis=-1
        )
        lp = jax.vmap(lambda x: g.von_mises_fisher.logpdf(x, mu, conc))(x)
        # density on sphere integrated: int p dA = 2 pi int p(t) dt = 1
        integral = float(jnp.trapezoid(jnp.exp(lp), t)) * 2 * np.pi
        np.testing.assert_allclose(integral, 1.0, atol=5e-3)

    def test_sampler_matches_density_histogram(self):
        mu = jnp.array([0.0, 0.0, 1.0])
        conc = 3.0
        keys = jax.random.split(KEY, 20000)
        xs = np.asarray(
            jax.vmap(lambda k: g.von_mises_fisher.sample(k, mu, conc))(keys)
        )
        t = xs[:, 2]
        # marginal density of t for d=3: p(t) = C * 2pi * exp(k t),
        # C = k/(4 pi sinh k) -> p(t) = k e^{kt} / (2 sinh k).
        k = conc
        for thr in [-0.5, 0.0, 0.5]:
            want = float(
                (np.exp(k * thr) - np.exp(-k)) / (2 * np.sinh(k))
            )
            emp = float(np.mean(t <= thr))
            assert abs(want - emp) < 0.015, (thr, want, emp)
