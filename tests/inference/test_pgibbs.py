"""Particle Gibbs / PGAS vs the exact RTS smoother on a linear-Gaussian
SSM: posterior state means, ancestor-sampling mixing advantage, and
CSMC bookkeeping identities."""

import jax
import jax.numpy as jnp
import numpy as np

from genjax_xla.inference.pgibbs import (
    conditional_bootstrap_filter,
    particle_gibbs,
)
from genjax_xla.models.ssm import kalman_filter, kalman_smoother

KEY = jax.random.key(314159)
A, Q, R = 0.9, 0.5, 0.5
T = 15


def make_model():
    sig1 = jnp.sqrt(A * A + Q)

    def init_sampler(key, n):
        return sig1 * jax.random.normal(key, (n,))

    def propagate(key, xs):
        return A * xs + jnp.sqrt(Q) * jax.random.normal(key, xs.shape)

    def loglik(xs, y):
        return jax.scipy.stats.norm.logpdf(y, xs, jnp.sqrt(R))

    def trans_logpdf(x_prev, x_next):
        return jax.scipy.stats.norm.logpdf(
            x_next, A * x_prev, jnp.sqrt(Q)
        )

    return init_sampler, propagate, loglik, trans_logpdf


def simulate_data(key, t=T):
    ks = jax.random.split(key, 2 * t)
    x = jnp.sqrt(A * A + Q) * jax.random.normal(ks[0])
    xs, ys = [], []
    for i in range(t):
        if i > 0:
            x = A * x + jnp.sqrt(Q) * jax.random.normal(ks[2 * i])
        xs.append(x)
        ys.append(x + jnp.sqrt(R) * jax.random.normal(ks[2 * i + 1]))
    return jnp.stack(xs), jnp.stack(ys)


XS_TRUE, YS = simulate_data(jax.random.key(2))


class TestAgainstSmoother:
    def _run(self, trans_logpdf, n_iters=500, n_particles=64):
        init_sampler, propagate, loglik, tl = make_model()
        run = particle_gibbs(
            init_sampler, propagate, loglik, n_particles, n_iters,
            trans_logpdf=tl if trans_logpdf else None,
        )
        res = jax.jit(lambda k: run(k, YS))(KEY)
        return res

    def test_pgas_matches_smoother_means(self):
        res = self._run(trans_logpdf=True)
        paths = np.asarray(res.paths)[100:]
        _, mu_s, p_s = kalman_smoother(YS, A, Q, R)
        err = np.abs(paths.mean(axis=0) - np.asarray(mu_s))
        assert err.max() < 0.12, err
        # marginal stds too (mixing across the whole path)
        serr = np.abs(paths.std(axis=0) - np.sqrt(np.asarray(p_s)))
        assert serr.max() < 0.12, serr

    def test_plain_pg_matches_smoother_means(self):
        res = self._run(trans_logpdf=False, n_iters=800)
        paths = np.asarray(res.paths)[200:]
        _, mu_s, _ = kalman_smoother(YS, A, Q, R)
        err = np.abs(paths.mean(axis=0) - np.asarray(mu_s))
        assert err.max() < 0.15, err

    def test_logz_estimates_near_kalman(self):
        res = self._run(trans_logpdf=True, n_iters=200)
        ll, _ = kalman_filter(YS, A, Q, R)
        # CSMC logZ estimates concentrate near the exact marginal.
        assert abs(float(np.median(np.asarray(res.log_zs))) - float(ll)) < 0.5

    def test_ancestor_sampling_mixes_early_states_better(self):
        """Path-degeneracy signature: with few particles and a long
        series, the FIRST state's chain autocorrelation is much higher
        without ancestor sampling."""

        def lag1(z):
            z = z - z.mean()
            return float((z[1:] * z[:-1]).mean() / (z * z).mean())

        init_sampler, propagate, loglik, tl = make_model()
        xs, ys = simulate_data(jax.random.key(5), t=40)
        common = (init_sampler, propagate, loglik, 16, 300)
        r_pg = jax.jit(
            lambda k: particle_gibbs(*common)(k, ys)
        )(KEY)
        r_pgas = jax.jit(
            lambda k: particle_gibbs(*common, trans_logpdf=tl)(k, ys)
        )(KEY)
        ac_pg = lag1(np.asarray(r_pg.paths)[50:, 0])
        ac_pgas = lag1(np.asarray(r_pgas.paths)[50:, 0])
        assert ac_pgas < ac_pg, (ac_pgas, ac_pg)
        assert ac_pgas < 0.5


class TestCSMCMechanics:
    def test_retained_lane_survives_when_dominant(self):
        """If the reference path is forced to have (near) all the
        likelihood mass, the fresh draw equals the reference."""
        init_sampler, propagate, _, _ = make_model()

        def loglik_sharp(xs, y):
            return jnp.where(jnp.abs(xs - y) < 1e-3, 0.0, -1e9)

        csmc = conditional_bootstrap_filter(
            init_sampler, propagate, loglik_sharp, 8
        )
        ref = jnp.linspace(-1.0, 1.0, T)
        path, _ = csmc(KEY, ref, ref)  # ys == ref: only ref matches
        np.testing.assert_allclose(
            np.asarray(path), np.asarray(ref), atol=1e-6
        )

    def test_shapes_and_jit(self):
        init_sampler, propagate, loglik, _ = make_model()
        csmc = jax.jit(conditional_bootstrap_filter(
            init_sampler, propagate, loglik, 32
        ))
        path, log_z = csmc(KEY, YS, jnp.zeros(T))
        assert path.shape == (T,)
        assert jnp.isfinite(log_z)


class TestTraceParticleGibbs:
    """GFI-native particle Gibbs on an @gen Scan LGSSM, vs the exact
    RTS smoother (mu0=0, p0=0: x_1 ~ N(0, Q))."""

    def _model(self, t=10):
        import genjax_xla as g

        @g.gen
        def step(carry, _):
            prev = carry
            x = g.normal(A * prev, jnp.sqrt(Q)) @ "x"
            g.normal(x, jnp.sqrt(R)) @ "y"
            return x, x

        return step.scan(n=t), (0.0, None)

    def test_matches_smoother(self):
        from genjax_xla.inference.pgibbs import trace_particle_gibbs

        t = 10
        ys = YS[:t]
        model, args = self._model(t)
        run = trace_particle_gibbs(
            model, args, "y", ys, ("x",), n_particles=64, n_iters=500
        )
        res = jax.jit(run)(KEY)
        paths = np.asarray(res.paths["x"])[100:]
        _, mu_s, p_s = kalman_smoother(ys, A, Q, R, mu0=0.0, p0=0.0)
        err = np.abs(paths.mean(axis=0) - np.asarray(mu_s))
        assert err.max() < 0.15, err
        serr = np.abs(paths.std(axis=0) - np.sqrt(np.asarray(p_s)))
        assert serr.max() < 0.15, serr

    def test_logz_near_kalman(self):
        from genjax_xla.inference.pgibbs import trace_particle_gibbs

        t = 10
        ys = YS[:t]
        model, args = self._model(t)
        run = trace_particle_gibbs(
            model, args, "y", ys, ("x",), n_particles=64, n_iters=100
        )
        res = jax.jit(run)(KEY)
        ll, _ = kalman_filter(ys, A, Q, R, mu0=0.0, p0=0.0)
        assert abs(float(np.median(np.asarray(res.log_zs))) - float(ll)) < 0.5

    def test_retained_lane_pinned_exactly(self):
        """One sweep with a dominant reference: with near-zero
        observation noise and observations exactly on the reference
        path, only the pinned lane has any likelihood mass, so the
        fresh draw must equal the reference bitwise (pinning +
        conditional resampling + future refresh + assimilation leave
        the retained lane intact end to end)."""
        import genjax_xla as g
        from genjax_xla.inference.pgibbs import trace_csmc

        t = 6

        @g.gen
        def step(carry, _):
            prev = carry
            x = g.normal(A * prev, jnp.sqrt(Q)) @ "x"
            g.normal(x, 1e-4) @ "y"
            return x, x

        model = step.scan(n=t)
        ref = {"x": jnp.linspace(-1.0, 1.0, t)}
        csmc = trace_csmc(model, (0.0, None), "y", ref["x"], ("x",), 8)
        new_ref, log_z = jax.jit(csmc)(KEY, ref)
        np.testing.assert_array_equal(
            np.asarray(new_ref["x"]), np.asarray(ref["x"])
        )
        assert jnp.isfinite(log_z)


class TestTracePGAS:
    """GFI-native ancestor sampling: transition scores via assess,
    ancestor splice via Update — no hand-written densities."""

    def _series(self, t=40):
        key = jax.random.key(5)
        ks = jax.random.split(key, 2 * t)
        x, ys = 0.0, []
        for i in range(t):
            x = A * x + float(jnp.sqrt(Q)) * jax.random.normal(ks[2 * i])
            ys.append(
                x + float(jnp.sqrt(R)) * jax.random.normal(ks[2 * i + 1])
            )
        return jnp.stack(ys)

    def _model(self, t):
        import genjax_xla as g

        @g.gen
        def step(carry, _):
            prev = carry
            z = g.normal(A * prev, jnp.sqrt(Q)) @ "x"
            g.normal(z, jnp.sqrt(R)) @ "y"
            return z, z

        return step.scan(n=t)

    def test_pgas_mixes_and_matches_smoother(self):
        from genjax_xla.inference.pgibbs import trace_particle_gibbs

        t = 40
        ys = self._series(t)
        model = self._model(t)

        def lag1(z):
            z = z - z.mean()
            return float((z[1:] * z[:-1]).mean() / (z * z).mean())

        common = (model, (0.0, None), "y", ys, ("x",), 16, 300)
        r_pg = jax.jit(trace_particle_gibbs(*common))(KEY)
        r_pgas = jax.jit(
            trace_particle_gibbs(*common, ancestor_sampling=True)
        )(KEY)
        ac_pg = lag1(np.asarray(r_pg.paths["x"])[50:, 0])
        ac_pgas = lag1(np.asarray(r_pgas.paths["x"])[50:, 0])
        assert ac_pgas < ac_pg, (ac_pgas, ac_pg)
        assert ac_pgas < 0.5

        paths = np.asarray(r_pgas.paths["x"])[50:]
        _, mu_s, p_s = kalman_smoother(ys, A, Q, R, mu0=0.0, p0=0.0)
        assert np.abs(paths.mean(0) - np.asarray(mu_s)).max() < 0.2
        assert np.abs(
            paths.std(0) - np.sqrt(np.asarray(p_s))
        ).max() < 0.2
