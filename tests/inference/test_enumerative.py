"""Exact enumerative posteriors (inference/enumerative.py): closed-form
agreement on boolean and categorical graphs, evidence values, the MAP /
marginal helpers, SMC cross-checks, and the guard rails."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import genjax_xla as g
from genjax_xla.inference import Target, enumerate_posterior

KEY = jax.random.key(99)


class TestClosedForms:
    def test_two_flip_noisy_or(self):
        """Classic noisy-OR: exact posterior over (a, b) given the
        symptom, versus hand-computed Bayes."""

        @g.gen
        def noisy_or():
            a = g.flip(0.3) @ "a"
            b = g.flip(0.4) @ "b"
            p_sym = 0.05 + 0.9 * jnp.asarray(
                a | b, jnp.float32
            )
            _ = g.flip(p_sym) @ "sym"

        target = Target(noisy_or, (), g.C["sym"].set(True))
        res = enumerate_posterior(target)

        # Hand computation over the 4 states.
        joint = {}
        for a in (0, 1):
            for b in (0, 1):
                pa = 0.3 if a else 0.7
                pb = 0.4 if b else 0.6
                ps = 0.05 + 0.9 * (1 if (a or b) else 0)
                joint[(a, b)] = pa * pb * ps
        z = sum(joint.values())
        np.testing.assert_allclose(
            float(jnp.exp(res.log_marginal)), z, rtol=1e-6
        )
        sup_a, marg_a = res.site_marginal("a")
        want_a1 = (joint[(1, 0)] + joint[(1, 1)]) / z
        np.testing.assert_allclose(
            float(marg_a[np.asarray(sup_a).tolist().index(True)]),
            want_a1, rtol=1e-6,
        )

    def test_categorical_mixture_assignment(self):
        """Posterior over the mixture component given one observation
        matches Bayes' rule exactly."""
        mus = jnp.array([-2.0, 0.0, 3.0])
        logits = jnp.log(jnp.array([0.5, 0.3, 0.2]))

        @g.gen
        def mix():
            zc = g.categorical(logits) @ "z"
            _ = g.normal(mus[zc], 1.0) @ "y"

        y_obs = 2.0
        target = Target(mix, (), g.C["y"].set(y_obs))
        res = enumerate_posterior(target)
        sup, probs = res.site_marginal("z")
        from jax.scipy.stats import norm

        w = jnp.exp(logits) * norm.pdf(y_obs, mus, 1.0)
        want = np.asarray(w / w.sum())
        np.testing.assert_allclose(np.asarray(probs), want, rtol=1e-5)
        assert res.map_assignment()[("z",)] == 2

    def test_nested_gen_addresses(self):
        @g.gen
        def inner():
            return g.flip(0.5) @ "c"

        @g.gen
        def outer():
            a = inner() @ "in"
            _ = g.flip(jnp.where(a, 0.9, 0.1)) @ "obs"

        target = Target(outer, (), g.C["obs"].set(True))
        res = enumerate_posterior(target)
        assert res.paths == (("in", "c"),)
        sup, probs = res.site_marginal("in", "c")
        # P(c|obs) = 0.9 / (0.9 + 0.1) = 0.9.
        np.testing.assert_allclose(
            float(probs[np.asarray(sup).tolist().index(True)]),
            0.9, rtol=1e-6,
        )


class TestCrossChecks:
    def test_smc_logz_matches_enumerated_evidence(self):
        logits = jnp.zeros(4)

        @g.gen
        def m():
            zc = g.categorical(logits) @ "z"
            b = g.flip(jnp.array([0.1, 0.4, 0.6, 0.9])[zc]) @ "b"
            _ = g.flip(jnp.where(b, 0.8, 0.2)) @ "y"

        target = Target(m, (), g.C["y"].set(True))
        res = enumerate_posterior(target)

        from genjax_xla.inference import ImportanceK

        alg = ImportanceK(target, k_particles=4096)
        col = jax.jit(alg.run_smc)(KEY)
        lz = float(col.get_log_marginal_likelihood_estimate())
        assert abs(lz - float(res.log_marginal)) < 0.05


class TestGuards:
    def test_continuous_latent_raises(self):
        @g.gen
        def m():
            x = g.normal(0.0, 1.0) @ "x"
            _ = g.flip(jax.nn.sigmoid(x)) @ "y"

        with pytest.raises(ValueError, match="not finite-support"):
            enumerate_posterior(Target(m, (), g.C["y"].set(True)))

    def test_state_cap_raises(self):
        @g.gen
        def m():
            for i in range(6):
                _ = g.categorical(jnp.zeros(10)) @ f"z{i}"
            _ = g.flip(0.5) @ "y"

        with pytest.raises(ValueError, match="max_states"):
            enumerate_posterior(
                Target(m, (), g.C["y"].set(True)), max_states=1000
            )

    def test_all_constrained_raises(self):
        @g.gen
        def m():
            _ = g.flip(0.5) @ "y"

        with pytest.raises(ValueError, match="no unconstrained"):
            enumerate_posterior(Target(m, (), g.C["y"].set(True)))
