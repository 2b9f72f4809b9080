"""log-matmul: the max-shift form vs naive logsumexp, its stated
precision, and the parallel-prefix HMM filter built on it against the
sequential filter."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.scipy.special import logsumexp

from genjax_xla.ops import log_matmul

KEY = jax.random.key(314159)


def naive(X, Y):
    return logsumexp(X[..., :, :, None] + Y[..., None, :, :], axis=-2)


class TestJnp:
    def test_matches_naive(self):
        X = jax.random.normal(KEY, (64, 64)) * 3.0
        Y = jax.random.normal(jax.random.key(1), (64, 64)) * 3.0
        np.testing.assert_allclose(
            np.asarray(log_matmul(X, Y)), np.asarray(naive(X, Y)),
            rtol=1e-5, atol=1e-5,
        )

    def test_batched(self):
        X = jax.random.normal(KEY, (4, 32, 32))
        Y = jax.random.normal(jax.random.key(1), (4, 32, 32))
        np.testing.assert_allclose(
            np.asarray(log_matmul(X, Y)), np.asarray(naive(X, Y)),
            rtol=1e-5, atol=1e-5,
        )

    def test_extreme_values_stable(self):
        X = jnp.full((8, 8), -1e30)
        Y = jnp.zeros((8, 8))
        out = log_matmul(X, Y)
        assert bool(jnp.all(jnp.isfinite(out) | (out < -1e29)))


def test_product_runs_at_highest_precision():
    """The matmul inside is asked for at Precision.HIGHEST, so no backend
    may lower it to TF32 or bf16 passes."""
    X = jnp.zeros((2, 8, 8))
    text = jax.jit(log_matmul).lower(X, X).as_text()
    assert "HIGHEST" in text.upper()
    plain = jax.jit(jnp.matmul).lower(X, X).as_text()
    assert "HIGHEST" not in plain.upper()


@pytest.mark.parametrize("states,steps", [(8, 64), (128, 128), (256, 128)])
def test_parallel_filter_matches_sequential(states, steps):
    """Parallel-prefix filtering (associative scan of log_matmul) against
    the sequential forward filter, float32 at HIGHEST: filtering
    distributions within 1e-3 in L1 and the log-marginal within 1e-5
    relative (float32 round-off of log-values as large as |log Z|)."""
    from genjax_xla.inference.exact_testbed import sample_problem
    from genjax_xla.lang.distributions.discrete_hmm import (
        DiscreteHMMConfiguration,
        forward_filter,
        forward_filter_parallel,
    )

    config = DiscreteHMMConfiguration.circulant(states, states)
    obs = sample_problem(jax.random.key(3), config, steps).observations
    a_seq, lz_seq = jax.jit(lambda o: forward_filter(config, o))(obs)
    a_par, lz_par = jax.jit(lambda o: forward_filter_parallel(config, o))(obs)
    l1 = jnp.max(jnp.sum(jnp.abs(
        jax.nn.softmax(a_par, -1) - jax.nn.softmax(a_seq, -1)), -1))
    assert float(l1) < 1e-3
    assert abs(float(lz_par) - float(lz_seq)) <= 1e-5 * abs(float(lz_seq))
