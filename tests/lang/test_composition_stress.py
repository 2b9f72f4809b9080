"""Deep-composition stress tests: combinators nested in combinators,
Marginal used as a distribution inside @gen, algorithms as proposals."""

import jax
import jax.numpy as jnp
import numpy as np

import genjax_xla as g
from genjax_xla.inference import ImportanceK, Importance, Target, marginal

KEY = jax.random.key(314159)


class TestNestedCombinators:
    def test_scan_of_vmap(self):
        @g.gen
        def leaf(mu):
            return g.normal(mu, 1.0) @ "x"

        vm = leaf.vmap(in_axes=0)

        @g.gen
        def step(carry, _):
            xs = vm(carry * jnp.ones(3)) @ "lanes"
            return jnp.mean(xs), None

        sc = step.scan(n=4)
        tr = sc.simulate(KEY, (0.0, None))
        assert bool(jnp.isfinite(tr.get_score()))
        score, _ = sc.assess(tr.get_choices(), (0.0, None))
        assert jnp.allclose(score, tr.get_score(), atol=1e-5)

    def test_vmap_of_scan(self):
        @g.gen
        def step(carry, _):
            x = g.normal(carry, 1.0) @ "x"
            return x, x

        sc = step.scan(n=3)
        vm = sc.vmap(in_axes=0)
        tr = vm.simulate(KEY, (jnp.arange(4.0), None))
        assert tr.get_choices()[2, 1, "x"] is not None
        score, _ = vm.assess(
            tr.get_choices(), (jnp.arange(4.0), None)
        )
        assert jnp.allclose(score, tr.get_score(), atol=1e-5)

    def test_switch_inside_scan(self):
        @g.gen
        def b0(c):
            return g.normal(c, 1.0) @ "x"

        @g.gen
        def b1(c):
            return g.normal(-c, 1.0) @ "x"

        sw = g.switch(b0, b1)

        @g.gen
        def step(carry, _):
            idx = g.flip(0.5) @ "branch"
            x = sw(jnp.asarray(idx, jnp.int32), (carry,), (carry,)) @ "sw"
            return x, None

        sc = step.scan(n=3)
        tr = jax.jit(sc.simulate)(KEY, (1.0, None))
        assert bool(jnp.isfinite(tr.get_score()))

    def test_mask_of_scan_update(self):
        @g.gen
        def step(carry, _):
            x = g.normal(carry, 1.0) @ "x"
            return x, None

        m = step.scan(n=3).mask()
        tr = m.simulate(KEY, (True, 0.0, None))
        new_tr, w, _, _ = tr.update(
            jax.random.key(1), g.C[0, "x"].set(0.5)
        )
        assert jnp.allclose(
            w, new_tr.get_score() - tr.get_score(), atol=1e-5
        )


class TestMarginalInsideGen:
    def test_marginal_as_distribution(self):
        """A Marginal (algorithm-backed distribution over choicemaps) used
        as a sampling primitive inside another @gen model."""

        @marginal(selection=g.S.at["p"])
        @g.gen
        def noisy_prior():
            p = g.beta(2.0, 2.0) @ "p"
            _ = g.flip(p) @ "obs"

        @g.gen
        def outer():
            chm = noisy_prior() @ "inner"
            return chm

        tr = outer.simulate(KEY, ())
        assert bool(jnp.isfinite(tr.get_score()))
        # the inner choice map carries the "p" latent
        inner = tr.get_choices()["inner"]
        assert bool(jnp.isfinite(jnp.asarray(inner["p"])))


class TestAlgorithmAsProposal:
    def test_importance_with_smc_proposal(self):
        """ImportanceK using another algorithm's Marginal as its q."""

        @g.gen
        def model():
            mu = g.normal(0.0, 1.0) @ "mu"
            _ = g.normal(mu, 0.5) @ "y"

        target = Target(model, (), g.C["y"].set(1.0))

        @marginal()
        @g.gen
        def q(target):
            _ = g.normal(0.8, 0.5) @ "mu"

        alg = ImportanceK(target, q, k_particles=100)
        keys = jax.random.split(KEY, 200)
        est = jax.vmap(
            lambda k: alg.log_marginal_likelihood_estimate(k)
        )(keys)
        logz = jax.scipy.special.logsumexp(est) - jnp.log(len(est))
        from scipy.stats import norm

        want = norm(0.0, np.sqrt(1.25)).logpdf(1.0)
        assert abs(float(logz) - want) < 0.05
