"""SVGD tests (inference/svgd.py): moment recovery on conjugate targets,
support transforms, and the matrix-form phi against a per-pair oracle."""

import jax
import jax.numpy as jnp
import numpy as np

import genjax_xla as g
from genjax_xla.inference import Target, run_svgd
from genjax_xla.inference.svgd import _rbf_phi, svgd_step

KEY = jax.random.key(2718)


class TestPhi:
    def test_matrix_phi_matches_pairwise_oracle(self):
        """The matmul-form phi equals the O(N^2 D) per-pair definition."""
        xs = jax.random.normal(KEY, (32, 3))
        grads = jax.random.normal(jax.random.fold_in(KEY, 1), (32, 3))

        phi = _rbf_phi(xs, grads)

        # Oracle: explicit double loop over particles.
        sq = jnp.sum(xs * xs, axis=1)
        d2 = jnp.maximum(sq[:, None] - 2 * xs @ xs.T + sq[None, :], 0.0)
        h = jnp.maximum(jnp.median(d2) / jnp.log(32 + 1.0), 1e-6)
        n = xs.shape[0]
        oracle = np.zeros((n, 3))
        for i in range(n):
            acc = np.zeros(3)
            for j in range(n):
                k = float(jnp.exp(-d2[j, i] / h))
                acc += k * np.asarray(grads[j])
                acc += (2.0 / float(h)) * k * np.asarray(xs[i] - xs[j])
            oracle[i] = acc / n
        np.testing.assert_allclose(np.asarray(phi), oracle, rtol=2e-4,
                                   atol=1e-5)

    def test_gaussian_moment_recovery(self):
        """Raw svgd_step loop matches a correlated Gaussian's moments."""
        cov = jnp.array([[1.0, 0.6], [0.6, 2.0]])
        prec = jnp.linalg.inv(cov)
        mu = jnp.array([1.5, -0.5])

        def logp(z):
            return -0.5 * (z - mu) @ prec @ (z - mu)

        xs = jax.random.normal(KEY, (256, 2))

        def body(xs, _):
            return svgd_step(logp, xs, 0.2), None

        xs, _ = jax.lax.scan(body, xs, None, length=600)
        emp_mu = np.asarray(jnp.mean(xs, axis=0))
        emp_cov = np.asarray(jnp.cov(np.asarray(xs).T))
        np.testing.assert_allclose(emp_mu, np.asarray(mu), atol=0.1)
        np.testing.assert_allclose(emp_cov, np.asarray(cov), atol=0.3)


class TestRunSVGD:
    def test_conjugate_normal_posterior(self):
        @g.gen
        def model():
            mu = g.normal(0.0, 1.0) @ "mu"
            _ = g.normal(mu, 0.5) @ "y"

        target = Target(model, (), g.C["y"].set(1.0))
        chm = jax.jit(
            lambda k: run_svgd(target, k, n_particles=256, n_steps=400,
                               step_size=0.1)
        )(KEY)
        mus = np.asarray(chm["mu"])
        assert mus.shape == (256,)
        # Exact posterior: N(0.8, sqrt(0.2)).
        assert abs(mus.mean() - 0.8) < 0.06
        assert abs(mus.std() - np.sqrt(0.2)) < 0.06

    def test_auto_transforms_positive_support(self):
        @g.gen
        def model():
            sigma = g.gamma(3.0, 3.0) @ "sigma"
            _ = g.normal(0.0, sigma) @ "y"

        target = Target(model, (), g.C["y"].set(0.5))
        chm = jax.jit(
            lambda k: run_svgd(target, k, n_particles=128, n_steps=300,
                               step_size=0.05, transforms="auto")
        )(KEY)
        sig = np.asarray(chm["sigma"])
        assert (sig > 0).all()
        # Posterior mass concentrates below the prior mean 1.0 given the
        # small observation.
        assert 0.3 < sig.mean() < 1.0


class TestDiscreteGuard:
    def test_unconstrained_discrete_site_raises(self):
        """ADVICE r4: SVGD on a model with an unconstrained flip must
        raise loudly instead of silently writing drifted floats back
        into the discrete address."""
        import pytest

        @g.gen
        def model():
            z = g.flip(0.3) @ "z"
            _ = g.normal(jnp.where(z, 1.0, -1.0), 0.5) @ "y"

        target = Target(model, (), g.C["y"].set(0.8))
        with pytest.raises(ValueError, match="discrete|flip"):
            run_svgd(target, KEY, n_particles=8, n_steps=1)

    def test_constrained_discrete_site_is_fine(self):
        """A discrete site pinned by the target constraint is not part
        of the position vector — no error, inference proceeds."""

        @g.gen
        def model():
            z = g.flip(0.3) @ "z"
            mu = g.normal(0.0, 1.0) @ "mu"
            _ = g.normal(mu + jnp.where(z, 1.0, 0.0), 0.5) @ "y"

        target = Target(
            model, (), g.C["y"].set(0.8) | g.C["z"].set(True)
        )
        chm = run_svgd(target, KEY, n_particles=32, n_steps=50)
        assert np.isfinite(np.asarray(chm["mu"])).all()


class TestBandwidthSubsample:
    def test_clustered_ordering_robust(self):
        """Review r5: the bandwidth subsample is STRIDED, so an xs
        whose leading block is one tight cluster (per-mode
        concatenation) must not collapse h — the strided median stays
        within a factor of the exact one and repulsion survives."""
        k1, k2 = jax.random.split(jax.random.key(31))
        # Two well-separated clusters, CONCATENATED (ordered).
        a = -5.0 + 0.01 * jax.random.normal(k1, (512, 2))
        b = 5.0 + 0.01 * jax.random.normal(k2, (512, 2))
        xs = jnp.concatenate([a, b])
        grads = jnp.zeros_like(xs)
        phi_exact = _rbf_phi(xs, grads, h_rows=None)
        phi_sub = _rbf_phi(xs, grads, h_rows=64)
        # With zero score gradients phi is pure repulsion; a collapsed
        # bandwidth would zero it out. Require the subsampled phi to
        # stay within 2x of the exact-median repulsion magnitude.
        m_exact = float(jnp.abs(phi_exact).mean())
        m_sub = float(jnp.abs(phi_sub).mean())
        assert m_sub > 0.5 * m_exact, (m_sub, m_exact)

    def test_iid_subsample_close_to_exact(self):
        xs = jax.random.normal(jax.random.key(32), (1024, 4))
        grads = jax.random.normal(jax.random.key(33), (1024, 4))
        p1 = np.asarray(_rbf_phi(xs, grads, h_rows=None))
        p2 = np.asarray(_rbf_phi(xs, grads, h_rows=128))
        # Same statistic, different sample: directions nearly equal.
        cos = (p1 * p2).sum() / (
            np.linalg.norm(p1) * np.linalg.norm(p2)
        )
        assert cos > 0.99, cos
