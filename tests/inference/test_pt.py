"""Parallel tempering: cold-chain correctness on a conjugate target,
swap-acceptance identities, and the flagship multimodal test — a local
drift kernel that provably sticks in one mode mixes across both once
replica exchange is added."""

import jax
import jax.numpy as jnp
import numpy as np

import genjax_xla as g
from genjax_xla.inference import Target
from genjax_xla.inference.pt import parallel_tempering
from genjax_xla.inference.requests.rejuvenate import Rejuvenate

KEY = jax.random.key(314159)


@g.gen
def conjugate_normal(obs_std):
    mu = g.normal(0.0, 1.0) @ "mu"
    y = g.normal(mu, obs_std) @ "y"
    return y


def drift_request(scale=0.4):
    @g.gen
    def drift(old):
        mu = g.normal(old["mu"], scale) @ "mu"
        return mu

    return Rejuvenate(drift)


class TestColdChainCorrectness:
    def test_posterior_mean_and_std(self):
        obs_std = 0.5
        tgt = Target(conjugate_normal, (obs_std,), g.C["y"].set(1.0))
        run = parallel_tempering(tgt, 4, make_request=drift_request)
        res = jax.jit(lambda k: run(
            k, 3000, collect=lambda tr: tr.get_choices()["mu"],
            burn_in=500,
        ))(KEY)
        mus = np.asarray(res.samples)
        mean = 1.0 / 1.25
        sd = np.sqrt(0.25 / 1.25)
        assert abs(mus.mean() - mean) < 5e-2
        assert abs(mus.std() - sd) < 5e-2
        # all within-temperature kernels actually move
        assert np.all(np.asarray(res.accept_rate) > 0.05)
        # swap attempts between adjacent rungs get accepted sometimes
        assert np.all(np.asarray(res.swap_rate) > 0.05)

    def test_all_cold_ladder_reduces_to_mh(self):
        """With every rung at beta=1 the swap ratio is exactly 0, so
        swaps always pass and every replica is a posterior chain."""
        tgt = Target(conjugate_normal, (0.5,), g.C["y"].set(1.0))
        run = parallel_tempering(
            tgt, jnp.ones(3), make_request=drift_request
        )
        res = jax.jit(lambda k: run(
            k, 2500, collect=lambda tr: tr.get_choices()["mu"],
            burn_in=500,
        ))(KEY)
        assert np.allclose(np.asarray(res.swap_rate), 1.0)
        assert abs(np.asarray(res.samples).mean() - 0.8) < 6e-2


@g.gen
def bimodal():
    x = g.normal(0.0, 4.0) @ "x"
    y = g.normal(x * x, 0.5) @ "y"   # y=4 => modes near x = +-2
    return x


class TestMultimodalMixing:
    """Posterior of x given y=4 is symmetric bimodal (+-2). A local
    drift kernel cannot cross the barrier; PT with hot rungs can."""

    def _cold_only_signs(self, key):
        tgt = Target(bimodal, (), g.C["y"].set(4.0))
        run = parallel_tempering(
            tgt, jnp.ones(2), make_request=lambda: drift_for_x(),
        )
        res = run(key, 2000, collect=lambda tr: tr.get_choices()["x"])
        return np.sign(np.asarray(res.samples)[200:])

    def test_pt_visits_both_modes_local_chain_does_not(self):
        tgt = Target(bimodal, (), g.C["y"].set(4.0))

        def local():
            @g.gen
            def drift(old):
                x = g.normal(old["x"], 0.3) @ "x"
                return x

            return Rejuvenate(drift)

        # Control: a true single chain with the same local kernel is
        # stuck in whichever mode it starts in (the barrier at x=0 is
        # ~32 nats deep).
        from genjax_xla.inference import chain, mh

        tr0, _ = bimodal.generate(
            jax.random.key(11), g.C["y"].set(4.0), ()
        )
        runner = chain(lambda k, t: mh(k, t, local()))
        _, xs0 = jax.jit(lambda k, t: runner(
            k, t, n_steps=2500,
            collect=lambda tr_: tr_.get_choices()["x"],
        ))(jax.random.key(12), tr0)
        signs0 = np.sign(np.asarray(xs0)[500:])
        assert (signs0 == signs0[0]).all(), "local chain should be stuck"

        # Real ladder: hot rungs flatten the barrier; swaps carry
        # mode flips down to the cold chain.
        run = parallel_tempering(
            tgt, jnp.array([0.02, 0.1, 0.3, 1.0]), make_request=local
        )
        res = jax.jit(lambda k: run(
            k, 2500, collect=lambda tr: tr.get_choices()["x"]
        ))(jax.random.key(11))
        xs = np.asarray(res.samples)[500:]
        signs = np.sign(xs)
        flips = int((signs[1:] != signs[:-1]).sum())
        assert flips >= 10, f"cold chain crossed only {flips} times"
        # Symmetric posterior: both modes materially occupied.
        frac_pos = (signs > 0).mean()
        assert 0.15 < frac_pos < 0.85
        # Samples concentrate near the modes.
        assert abs(np.abs(xs).mean() - 2.0) < 0.2


class TestSwapMechanics:
    def test_pair_swap_is_an_involution(self):
        from genjax_xla.inference.pt import _pair_swap

        tree = {"a": jnp.arange(6.0), "b": jnp.arange(12.0).reshape(6, 2)}
        acc = jnp.array([True, False, True, False, False, False])
        once = _pair_swap(tree, acc)
        twice = _pair_swap(once, acc)
        for k in tree:
            np.testing.assert_array_equal(
                np.asarray(twice[k]), np.asarray(tree[k])
            )
        # leader 0 swapped with 1; leader 2 with 3; 4,5 untouched
        np.testing.assert_array_equal(
            np.asarray(once["a"]), [1.0, 0.0, 3.0, 2.0, 4.0, 5.0]
        )
