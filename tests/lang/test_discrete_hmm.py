"""Discrete-HMM exactness tests: filtering vs brute-force enumeration,
sequential vs parallel-prefix filter agreement, FFBS posterior histogram,
and the testbed round trip."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np

from genjax_xla.lang.distributions.discrete_hmm import (
    DiscreteHMM,
    DiscreteHMMConfiguration,
    backward_sample,
    discrete_hmm,
    forward_filter,
    forward_filter_parallel,
    joint_logpdf,
)
from genjax_xla.inference.exact_testbed import (
    build_test_against_exact_inference,
)

KEY = jax.random.key(314159)


def brute_force_marginal(config, obs):
    S = config.num_states
    T = len(obs)
    total = -np.inf
    for z in itertools.product(range(S), repeat=T):
        z = jnp.asarray(z)
        total = np.logaddexp(total, float(joint_logpdf(config, z, obs)))
    return total


def small_config():
    return DiscreteHMMConfiguration.from_probs(
        jnp.array([0.6, 0.4]),
        jnp.array([[0.7, 0.3], [0.2, 0.8]]),
        jnp.array([[0.9, 0.1], [0.3, 0.7]]),
    )


class TestFiltering:
    def test_marginal_matches_enumeration(self):
        config = small_config()
        obs = jnp.array([0, 1, 1, 0])
        _, logm = forward_filter(config, obs)
        want = brute_force_marginal(config, obs)
        np.testing.assert_allclose(float(logm), want, rtol=1e-5)

    def test_parallel_filter_matches_sequential(self):
        config = DiscreteHMMConfiguration.circulant(7, 5)
        obs = jax.random.randint(KEY, (25,), 0, 5)
        a_seq, m_seq = forward_filter(config, obs)
        a_par, m_par = forward_filter_parallel(config, obs)
        np.testing.assert_allclose(
            np.asarray(a_seq), np.asarray(a_par), rtol=2e-5, atol=2e-5
        )
        np.testing.assert_allclose(float(m_seq), float(m_par), rtol=1e-5)

    def test_posterior_normalizes(self):
        config = small_config()
        obs = jnp.array([0, 1])
        total = -np.inf
        for z in itertools.product(range(2), repeat=2):
            lp = discrete_hmm.estimate_logpdf(
                KEY, jnp.asarray(z), config, obs
            )
            total = np.logaddexp(total, float(lp))
        np.testing.assert_allclose(total, 0.0, atol=1e-5)


class TestFFBS:
    def test_posterior_histogram(self):
        config = small_config()
        obs = jnp.array([0, 1, 0])
        keys = jax.random.split(KEY, 20000)
        zs = jax.vmap(
            lambda k: discrete_hmm.random_weighted(k, config, obs)[1]
        )(keys)
        # Exact posterior of each path by enumeration:
        for z in itertools.product(range(2), repeat=3):
            z_arr = jnp.asarray(z)
            want = float(
                jnp.exp(discrete_hmm.estimate_logpdf(KEY, z_arr, config, obs))
            )
            got = float(
                jnp.mean(jnp.all(zs == z_arr[None], axis=1))
            )
            assert abs(got - want) < 0.015, (z, got, want)

    def test_score_is_posterior_logpdf(self):
        config = small_config()
        obs = jnp.array([0, 1, 0, 0])
        score, z = discrete_hmm.random_weighted(KEY, config, obs)
        lp = discrete_hmm.estimate_logpdf(KEY, z, config, obs)
        np.testing.assert_allclose(float(score), float(lp), rtol=1e-5)

    def test_parallel_backward_sample_distribution(self):
        """The O(log T)-depth parallel backward sampler draws from the
        exact posterior (histogram vs enumeration)."""
        config = small_config()
        obs = jnp.array([0, 1, 0])
        par = DiscreteHMM(use_parallel_filter=True)
        keys = jax.random.split(KEY, 20000)
        zs = jax.vmap(lambda k: par.random_weighted(k, config, obs)[1])(
            keys
        )
        for z in itertools.product(range(2), repeat=3):
            z_arr = jnp.asarray(z)
            want = float(jnp.exp(
                discrete_hmm.estimate_logpdf(KEY, z_arr, config, obs)
            ))
            got = float(jnp.mean(jnp.all(zs == z_arr[None], axis=1)))
            assert abs(got - want) < 0.015, (z, got, want)

    def test_parallel_variant_same_score_semantics(self):
        config = small_config()
        obs = jnp.array([0, 1, 0])
        par = DiscreteHMM(use_parallel_filter=True)
        s2, z2 = par.random_weighted(KEY, config, obs)
        lp = par.estimate_logpdf(KEY, z2, config, obs)
        np.testing.assert_allclose(float(s2), float(lp), rtol=1e-5)


class TestTestbed:
    def test_problem_roundtrip(self):
        build = build_test_against_exact_inference(5, 5, 10)
        problem = jax.jit(build)(KEY)
        assert problem.observations.shape == (10,)
        assert bool(jnp.isfinite(problem.log_data_marginal))
        lp = problem.exact_posterior_logpdf(problem.latents)
        assert bool(jnp.isfinite(lp)) and float(lp) <= 0.0

    def test_sis_logz_matches_exact(self):
        """Importance sampling logZ on the HMM converges to the exact
        data marginal (benchmark config 3 sanity)."""
        import genjax_xla as g
        from genjax_xla.inference import ImportanceK, Target

        build = build_test_against_exact_inference(3, 3, 4)
        problem = build(KEY)
        config = problem.config

        @g.gen
        def step(z, x_obs):
            z_next = g.categorical(config.transition_logits[z]) @ "z"
            _ = g.categorical(config.observation_logits[z_next]) @ "x"
            return z_next, None

        @g.gen
        def hmm_model():
            z0 = g.categorical(config.prior_logits) @ "z0"
            _ = g.categorical(config.observation_logits[z0]) @ "x0"
            _ = step.scan(n=3)(z0, None) @ "chain"

        constraint = g.C["x0"].set(problem.observations[0])
        for t in range(3):
            constraint = constraint | g.C[
                "chain", t, "x"
            ].set(problem.observations[t + 1])
        target = Target(hmm_model, (), constraint)
        alg = ImportanceK(target, k_particles=3000)
        keys = jax.random.split(jax.random.key(5), 30)
        est = jax.vmap(lambda k: alg.log_marginal_likelihood_estimate(k))(
            keys
        )
        logz = jax.scipy.special.logsumexp(est) - jnp.log(len(est))
        np.testing.assert_allclose(
            float(logz), float(problem.log_data_marginal), atol=3e-2
        )
