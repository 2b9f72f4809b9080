"""SLDS Rao-Blackwellized particle filter vs the exact path-enumeration
oracle (models/slds.py): evidence accuracy, S=1 Kalman collapse, and
the Rao-Blackwell variance advantage over joint-space bootstrap."""

import jax
import jax.numpy as jnp
import numpy as np

from genjax_xla.models.slds import (
    SLDSParams,
    simulate_slds_data,
    slds_exact_log_marginal,
    slds_rbpf,
)

KEY = jax.random.key(20260820)


def _params(s=2):
    if s == 1:
        return SLDSParams(
            trans_logits=jnp.zeros((1, 1)),
            prior_logits=jnp.zeros(1),
            a=jnp.array([0.8]), q=jnp.array([0.3]), r=jnp.array([0.4]),
        )
    return SLDSParams(
        trans_logits=jnp.log(jnp.array([[0.9, 0.1], [0.2, 0.8]])),
        prior_logits=jnp.log(jnp.array([0.6, 0.4])),
        a=jnp.array([0.95, 0.3]),
        q=jnp.array([0.1, 0.8]),
        r=jnp.array([0.3, 0.3]),
    )


class TestExactOracle:
    def test_s1_collapses_to_kalman(self):
        """At S=1 both the enumeration oracle and the RBPF must equal
        the plain Kalman evidence."""
        from genjax_xla.models.ssm import kalman_filter

        p = _params(1)
        _, _, ys = simulate_slds_data(KEY, p, 12)
        exact = float(slds_exact_log_marginal(p, ys))
        # SLDS observes y_0 against the x_0 prior; kalman_filter's
        # convention applies the dynamics before its first y. Condition
        # on y_0 by hand, then hand the tail to the Kalman oracle.
        s0 = p.p0 + float(p.r[0])
        ll0 = -0.5 * (np.log(2 * np.pi * s0)
                      + (float(ys[0]) - p.mu0) ** 2 / s0)
        k0 = p.p0 / s0
        mu_post0 = p.mu0 + k0 * (float(ys[0]) - p.mu0)
        p_post0 = (1.0 - k0) * p.p0
        kf_ll, _ = kalman_filter(
            ys[1:], float(p.a[0]), float(p.q[0]), float(p.r[0]),
            mu0=mu_post0, p0=p_post0,
        )
        np.testing.assert_allclose(exact, ll0 + float(kf_ll), rtol=1e-5)
        run = slds_rbpf(p, n_particles=64)
        res = jax.jit(run)(jax.random.key(1), ys)
        # S=1: the predictive weights are identical across particles,
        # so the "estimate" is exact regardless of particle count.
        np.testing.assert_allclose(float(res.log_z), exact, rtol=1e-5)

    def test_rbpf_matches_enumeration(self):
        p = _params(2)
        _, _, ys = simulate_slds_data(KEY, p, 8)
        exact = float(slds_exact_log_marginal(p, ys))
        run = slds_rbpf(p, n_particles=4096)
        logzs = [
            float(jax.jit(run)(jax.random.fold_in(KEY, i), ys).log_z)
            for i in range(8)
        ]
        assert abs(np.mean(logzs) - exact) < 0.05, (np.mean(logzs), exact)
        assert np.std(logzs) < 0.1

    def test_regime_posterior_tracks_truth(self):
        """On a sharply identified sequence the final-regime posterior
        puts most mass on the true final regime."""
        p = _params(2)
        zs_true, _, ys = simulate_slds_data(
            jax.random.fold_in(KEY, 3), p, 30
        )
        res = jax.jit(slds_rbpf(p, n_particles=4096))(
            jax.random.key(5), ys
        )
        w = np.exp(np.asarray(res.log_weights)
                   - np.asarray(res.log_weights).max())
        w /= w.sum()
        p_true = float(
            w[np.asarray(res.regimes) == int(zs_true[-1])].sum()
        )
        assert p_true > 0.5, p_true


class TestRaoBlackwellAdvantage:
    def test_lower_logz_variance_than_bootstrap(self):
        """The marginalized filter's evidence estimate must have lower
        spread than a joint (z, x) bootstrap PF at equal particle
        count — the point of Rao-Blackwellization."""
        from genjax_xla.inference.pf import particle_filter

        p = _params(2)
        _, _, ys = simulate_slds_data(jax.random.fold_in(KEY, 7), p, 25)
        n = 512
        trans_cdf = jnp.cumsum(
            jax.nn.softmax(p.trans_logits, axis=-1), axis=-1
        )

        def init(key):
            kz, kx = jax.random.split(key)
            z = jax.random.categorical(kz, p.prior_logits, shape=(n,))
            x = p.mu0 + jnp.sqrt(p.p0) * jax.random.normal(kx, (n,))
            r_z = p.r[z]
            lw = jax.scipy.stats.norm.logpdf(ys[0], x, jnp.sqrt(r_z))
            return (z, x), lw

        def step(key, state, y):
            z, x = state
            kz, kx = jax.random.split(key)
            u = jax.random.uniform(kz, (n, 1))
            rowcdf = trans_cdf[z]
            z = jnp.minimum(jnp.sum(rowcdf < u, axis=-1), 1).astype(
                z.dtype
            )
            a_z, q_z, r_z = p.a[z], p.q[z], p.r[z]
            x = a_z * x + jnp.sqrt(q_z) * jax.random.normal(kx, (n,))
            lw = jax.scipy.stats.norm.logpdf(y, x, jnp.sqrt(r_z))
            return (z, x), lw

        joint_pf = particle_filter(init, step, n, batched=True)
        rb = slds_rbpf(p, n_particles=n)

        joint_logzs, rb_logzs = [], []
        for i in range(10):
            k = jax.random.fold_in(KEY, 100 + i)
            joint_logzs.append(
                float(jax.jit(lambda kk: joint_pf(kk, ys[1:])[0].log_z)(k))
            )
            rb_logzs.append(float(jax.jit(rb)(k, ys).log_z))
        exact = float(slds_exact_log_marginal(p, ys))
        # Both unbiased-ish; the RB spread must be strictly smaller.
        assert np.std(rb_logzs) < np.std(joint_logzs), (
            np.std(rb_logzs), np.std(joint_logzs),
        )
        assert abs(np.mean(rb_logzs) - exact) < 0.2
