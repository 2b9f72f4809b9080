"""Trace-level particle filter: logZ vs Kalman on the LGSSM model family,
posterior path access, ESS history."""

import jax
import jax.numpy as jnp
import numpy as np

import genjax_xla as g
from genjax_xla.inference.trace_pf import trace_particle_filter
from genjax_xla.models import kalman_filter, lgssm_model

KEY = jax.random.key(314159)


class TestTracePF:
    def test_logz_matches_kalman(self):
        a, q, r, T = 0.9, 0.5, 0.3, 8
        model = lgssm_model(a, q, r, T)
        data_tr = model.simulate(jax.random.key(7), (0.0, None))
        ys = jnp.stack(
            [data_tr.get_choices()[t, "y"] for t in range(T)]
        )
        # refresh_future=True prior-refreshes cloned futures after each
        # resampling: exactly the bootstrap PF (12x lower logZ std than
        # the shared-future variant).
        pf = trace_particle_filter(
            model, (0.0, None), "y", ys, n_particles=8192,
            refresh_future=True,
        )
        result = jax.jit(pf)(KEY)
        want, _ = kalman_filter(ys, a, q, r, mu0=0.0, p0=0.0)
        np.testing.assert_allclose(float(result.log_z), float(want),
                                   atol=0.1)

    def test_shared_future_variant_unbiased(self):
        a, q, r, T = 0.9, 0.5, 0.3, 6
        model = lgssm_model(a, q, r, T)
        ys = jnp.asarray([0.2, -0.1, 0.4, 0.0, 0.3, 0.1])
        pf = trace_particle_filter(model, (0.0, None), "y", ys, 8192)
        fn = jax.jit(pf)
        logzs = jnp.stack(
            [fn(jax.random.fold_in(KEY, k)).log_z for k in range(8)]
        )
        pooled = jax.scipy.special.logsumexp(logzs) - jnp.log(len(logzs))
        want, _ = kalman_filter(ys, a, q, r, mu0=0.0, p0=0.0)
        np.testing.assert_allclose(float(pooled), float(want), atol=0.2)

    def test_posterior_paths_conditioned(self):
        a, q, r, T = 0.9, 0.5, 0.3, 5
        model = lgssm_model(a, q, r, T)
        ys = jnp.asarray([1.0, 1.1, 0.9, 1.2, 1.0])
        pf = trace_particle_filter(
            model, (0.0, None), "y", ys, n_particles=2048
        )
        result = jax.jit(pf)(KEY)

        # Per-particle access: the traces are batched over particles, so
        # address lookups go through vmap (or slice one particle).
        def site(tr, t, addr):
            v = tr.get_choices()[t, addr]
            return v.unmask() if isinstance(v, g.Mask) else v

        ys_all = jax.vmap(
            lambda tr: jnp.stack([site(tr, t, "y") for t in range(T)])
        )(result.traces)
        np.testing.assert_allclose(
            np.asarray(ys_all),
            np.broadcast_to(np.asarray(ys), ys_all.shape),
            rtol=1e-6,
        )
        # Weighted mean of final latent near Kalman filtered mean:
        w = jax.nn.softmax(result.log_weights)
        x_T = jax.vmap(lambda tr: site(tr, T - 1, "x"))(result.traces)
        _, mus = kalman_filter(ys, a, q, r, 0.0, 0.0)
        assert abs(float((w * x_T).sum()) - float(mus[-1])) < 0.1

    def test_ess_history_shape(self):
        model = lgssm_model(0.9, 0.5, 0.3, 4)
        ys = jnp.zeros(4)
        pf = trace_particle_filter(model, (0.0, None), "y", ys, 256)
        result = jax.jit(pf)(KEY)
        assert result.ess_history.shape == (4,)
        assert bool(jnp.all(result.ess_history >= 1.0))
