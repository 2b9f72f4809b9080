"""Model-family tests: each family simulates, assesses, and supports the
inference algorithm it's designed for; oracles agree."""

import jax
import jax.numpy as jnp
import numpy as np

import genjax_xla as g
from genjax_xla.inference import ImportanceK, Target
from genjax_xla.models import (
    gaussian_mixture,
    hierarchical_regression,
    hmm_model,
    kalman_filter,
    lgssm_model,
    nonlinear_tracking_model,
)
from genjax_xla.lang.distributions.discrete_hmm import (
    DiscreteHMMConfiguration,
    forward_filter,
)

KEY = jax.random.key(314159)


class TestLGSSM:
    def test_smc_logz_matches_kalman(self):
        a, q, r, T = 0.9, 0.5, 0.3, 6
        model = lgssm_model(a, q, r, T)
        tr = model.simulate(KEY, (0.0, None))
        ys = jnp.stack([tr.get_choices()[t, "y"] for t in range(T)])
        constraint = g.ChoiceMap.empty()
        for t in range(T):
            constraint = constraint | g.C[t, "y"].set(ys[t])
        target = Target(model, (0.0, None), constraint)
        alg = ImportanceK(target, k_particles=20_000)
        keys = jax.random.split(jax.random.key(1), 10)
        est = jax.vmap(lambda k: alg.log_marginal_likelihood_estimate(k))(
            keys
        )
        logz = jax.scipy.special.logsumexp(est) - jnp.log(len(est))
        want, _ = kalman_filter(ys, a, q, r, mu0=0.0, p0=0.0)
        np.testing.assert_allclose(float(logz), float(want), atol=0.1)

    def test_nonlinear_tracking_builders(self):
        from genjax_xla.inference.pf import particle_filter

        init, step = nonlinear_tracking_model()
        ys = jax.random.normal(jax.random.key(2), (10,)) * 5.0
        pf = particle_filter(init, step, 2048)
        final, _ = jax.jit(lambda k: pf(k, ys))(KEY)
        assert bool(jnp.isfinite(final.log_z))


class TestRegression:
    def test_nuts_recovers_slope(self):
        from genjax_xla.inference import run_nuts

        xs = jnp.linspace(-1, 1, 25)
        ys = 1.5 * xs + 0.3
        model = hierarchical_regression()
        target = Target(model, (xs,), g.C["ys"].set(ys))
        chms, _ = jax.jit(
            lambda k: run_nuts(target, k, n_chains=2, num_warmup=200,
                               num_samples=300, max_depth=6)
        )(KEY)
        slopes = np.asarray(chms["slope"])
        assert abs(slopes.mean() - 1.5) < 0.1


class TestMixture:
    def test_simulate_assess(self):
        m = gaussian_mixture(3)
        logits = jnp.log(jnp.array([0.2, 0.3, 0.5]))
        locs = jnp.array([-5.0, 0.0, 5.0])
        scales = jnp.ones(3)
        tr = m.simulate(KEY, (logits, locs, scales))
        score, _ = m.assess(tr.get_choices(), (logits, locs, scales))
        assert jnp.allclose(score, tr.get_score())


class TestHMMModel:
    def test_importance_logz_matches_forward_filter(self):
        config = DiscreteHMMConfiguration.circulant(4, 4)
        T = 5
        model = hmm_model(config, T)
        tr = model.simulate(KEY, ())
        chm = tr.get_choices()
        obs = [int(chm["x0"])] + [
            int(chm["chain", t, "x"]) for t in range(T - 1)
        ]
        constraint = g.C["x0"].set(obs[0])
        for t in range(T - 1):
            constraint = constraint | g.C["chain", t, "x"].set(obs[t + 1])
        target = Target(model, (), constraint)
        alg = ImportanceK(target, k_particles=30_000)
        est = jax.vmap(lambda k: alg.log_marginal_likelihood_estimate(k))(
            jax.random.split(jax.random.key(7), 10)
        )
        logz = jax.scipy.special.logsumexp(est) - jnp.log(len(est))
        _, want = forward_filter(config, jnp.asarray(obs))
        np.testing.assert_allclose(float(logz), float(want), atol=0.05)
