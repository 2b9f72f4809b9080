"""Sequence parallelism (parallel/seq.py): time-axis-sharded forward
filtering — bitwise layout independence across mesh sizes, agreement with
the sequential filter, degenerate-case bitwise equality, contract errors,
and HLO bounds on the communicated summaries."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from genjax_xla.lang.distributions.discrete_hmm import (
    DiscreteHMMConfiguration,
    forward_filter,
)
from genjax_xla.parallel.seq import time_sharded_filter

T, S = 256, 8
BLOCK = 16


def _mesh_of(d, name="time"):
    return Mesh(np.asarray(jax.devices()[:d]), (name,))


@pytest.fixture(scope="module")
def problem():
    config = DiscreteHMMConfiguration.circulant(S, S)
    obs = jax.random.randint(jax.random.key(7), (T,), 0, S)
    return config, obs


class TestTimeShardedFilter:
    def test_bitwise_all_layouts(self, problem):
        config, obs = problem
        outs = []
        for d in (1, 2, 4, 8):
            mesh = _mesh_of(d)
            alphas, lz = jax.jit(
                lambda o, m=mesh: time_sharded_filter(
                    config, o, m, block=BLOCK
                )
            )(obs)
            outs.append((np.asarray(alphas), np.asarray(lz)))
        for a, z in outs[1:]:
            np.testing.assert_array_equal(a, outs[0][0])
            np.testing.assert_array_equal(z, outs[0][1])

    def test_matches_sequential_filter(self, problem):
        config, obs = problem
        want_a, want_z = forward_filter(config, obs)
        alphas, lz = jax.jit(
            lambda o: time_sharded_filter(
                config, o, _mesh_of(8), block=BLOCK
            )
        )(obs)
        np.testing.assert_allclose(
            np.asarray(alphas), np.asarray(want_a), rtol=2e-5, atol=1e-4
        )
        np.testing.assert_allclose(float(lz), float(want_z), rtol=1e-6)

    def test_single_device_full_block_bitwise_sequential(self, problem):
        """D=1 with block >= T degenerates to the sequential recursion."""
        config, obs = problem
        want_a, want_z = jax.jit(lambda o: forward_filter(config, o))(obs)
        alphas, lz = jax.jit(
            lambda o: time_sharded_filter(
                config, o, _mesh_of(1), block=T
            )
        )(obs)
        np.testing.assert_array_equal(
            np.asarray(alphas), np.asarray(want_a)
        )
        np.testing.assert_array_equal(np.asarray(lz), np.asarray(want_z))

    def test_nondividing_block_raises(self, problem):
        config, obs = problem
        with pytest.raises(ValueError, match="must divide"):
            time_sharded_filter(config, obs, _mesh_of(8), block=12)

    def test_nondividing_devices_raises(self, problem):
        config, obs = problem
        obs_odd = obs[: T - 6]
        with pytest.raises(ValueError, match="multiple of the mesh"):
            time_sharded_filter(config, obs_odd, _mesh_of(8), block=2)

    def test_hlo_gathers_only_block_summaries(self, problem):
        """The only gathered tensors are O(T/block · S²) block summaries
        — never the (T, S) per-step filter states."""
        config, obs = problem
        txt = (
            jax.jit(
                lambda o: time_sharded_filter(
                    config, o, _mesh_of(8), block=BLOCK
                )
            )
            .lower(obs)
            .compile()
            .as_text()
        )
        assert "all-gather" in txt
        for line in txt.splitlines():
            if "all-gather" in line or "all-reduce" in line:
                assert f"f32[{T},{S}]" not in line.replace(" ", ""), line

    def test_longer_chain_accuracy(self):
        """T=1024, S=16: log-marginal and filter marginals stay tight
        against the sequential filter (error does not accumulate with
        more blocks)."""
        config = DiscreteHMMConfiguration.circulant(16, 16)
        obs = jax.random.randint(jax.random.key(9), (1024,), 0, 16)
        want_a, want_z = forward_filter(config, obs)
        alphas, lz = jax.jit(
            lambda o: time_sharded_filter(
                config, o, _mesh_of(8), block=32
            )
        )(obs)
        np.testing.assert_allclose(float(lz), float(want_z), rtol=1e-5)
        # Normalized filter marginals (what inference consumes).
        from jax.scipy.special import logsumexp

        norm_got = np.asarray(
            alphas - logsumexp(alphas, axis=1, keepdims=True)
        )
        norm_want = np.asarray(
            want_a - logsumexp(want_a, axis=1, keepdims=True)
        )
        np.testing.assert_allclose(norm_got, norm_want, atol=5e-4)


class TestTimeShardedBackwardSample:
    def _setup(self, T=64, S=3):
        config = DiscreteHMMConfiguration.circulant(S, S)
        obs = jax.random.randint(jax.random.key(11), (T,), 0, S)
        return config, obs

    def test_bitwise_all_layouts(self):
        from genjax_xla.parallel.seq import time_sharded_backward_sample

        config, obs = self._setup()
        outs = []
        for d in (1, 2, 4, 8):
            mesh = _mesh_of(d)

            def run(o, m=mesh):
                alphas, _ = time_sharded_filter(config, o, m, block=8)
                return time_sharded_backward_sample(
                    jax.random.key(5), config, alphas, m, block=8
                )

            outs.append(np.asarray(jax.jit(run)(obs)))
        for z in outs[1:]:
            np.testing.assert_array_equal(z, outs[0])

    def test_smoothing_marginals_exact(self):
        """Empirical marginals of sampled paths match the exact
        forward-backward smoothing distribution."""
        from jax.scipy.special import logsumexp as lse

        from genjax_xla.parallel.seq import time_sharded_backward_sample

        T, S = 16, 3
        config, obs = self._setup(T, S)
        mesh = _mesh_of(4)
        want_a, _ = forward_filter(config, obs)

        # Exact betas: beta[T-1] = 0; beta[t] = log sum_j trans[., j]
        # + obs_ll[t+1, j] + beta[t+1, j].
        obs_ll = config.observation_logits[:, obs].T
        trans = config.transition_logits
        betas = [jnp.zeros(S)]
        for t in range(T - 2, -1, -1):
            betas.append(lse(
                trans + (obs_ll[t + 1] + betas[-1])[None, :], axis=1
            ))
        betas = jnp.stack(betas[::-1])
        gammas = want_a + betas
        exact = np.asarray(jax.nn.softmax(gammas, axis=1))

        def one(key):
            alphas, _ = time_sharded_filter(config, obs, mesh, block=4)
            return time_sharded_backward_sample(
                key, config, alphas, mesh, block=4
            )

        n = 4000
        zs = np.asarray(jax.jit(jax.vmap(one))(
            jax.random.split(jax.random.key(17), n)
        ))
        emp = np.stack([
            (zs == s).mean(axis=0) for s in range(S)
        ], axis=1)                                   # (T, S)
        np.testing.assert_allclose(emp, exact, atol=0.035)


class TestDefaultBlockLayoutFree:
    def test_default_block_bitwise_all_layouts(self, problem):
        """block=None derives the block from T alone (r4 review: the old
        clamp made the effective block device-count-dependent)."""
        config, obs = problem
        outs = []
        for d in (1, 2, 4, 8):
            alphas, lz = jax.jit(
                lambda o, m=_mesh_of(d): time_sharded_filter(
                    config, o, m
                )
            )(obs)
            outs.append((np.asarray(alphas), float(lz)))
        for a, z in outs[1:]:
            np.testing.assert_array_equal(a, outs[0][0])
            assert z == outs[0][1]

    def test_oversize_block_raises(self, problem):
        """block > T/D raises instead of clamping (r4 review)."""
        config, obs = problem
        with pytest.raises(ValueError, match="must divide"):
            time_sharded_filter(config, obs, _mesh_of(8), block=64)
