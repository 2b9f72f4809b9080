"""Systematic ``resample_tree`` against the ``jnp.repeat`` reference of
the same offspring counts (bitwise, across weight regimes and leaf
kinds), and the invariants of the offspring CDF it is built on."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from genjax_xla.inference.smc import (
    resample_tree,
    systematic_offspring_counts,
    systematic_offspring_cumulative,
)

N = 1024
REGIMES = ["uniform", "mild", "skewed", "one_hot", "two_far", "head_tail"]


def _log_weights(regime, n, key=jax.random.key(11)):
    i = jnp.arange(n)
    if regime == "uniform":
        return jnp.zeros(n)
    if regime == "mild":
        return jax.random.normal(key, (n,))
    if regime == "skewed":
        return 3.0 * jax.random.normal(key, (n,))
    if regime == "one_hot":
        return jnp.where(i == (389 * n) // 1024, 0.0, -1e9)
    if regime == "two_far":
        return jnp.where((i == 3) | (i == n - 2), 0.0, -1e9)
    return jnp.where(i < 8, 10.0, -2.0)  # head_tail


def _leaf(kind, n):
    k = jax.random.key(1)
    if kind == "f32":
        return jax.random.normal(k, (n,))
    if kind == "int32":
        return jax.random.randint(k, (n,), 0, 1 << 20)
    if kind == "bool":
        return jax.random.bernoulli(k, 0.5, (n,))
    if kind == "bf16":
        return jax.random.normal(k, (n,)).astype(jnp.bfloat16)
    return jax.random.normal(k, (n, 64))  # wide


@jax.jit
def _both(key, lw, leaf):
    n = lw.shape[0]
    counts = systematic_offspring_counts(key, lw, n)
    want = jnp.repeat(leaf, counts, axis=0, total_repeat_length=n)
    return resample_tree(key, lw, leaf, n), want, counts


@pytest.mark.parametrize("kind", ["f32", "int32", "bool", "bf16", "wide"])
@pytest.mark.parametrize("regime", REGIMES)
def test_systematic_matches_repeat_bitwise(regime, kind):
    key = jax.random.key(7)
    lw = _log_weights(regime, N)
    leaf = _leaf(kind, N)
    got, want, counts = _both(key, lw, leaf)
    assert int(counts.sum()) == N
    assert got.dtype == leaf.dtype and got.shape == leaf.shape
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("n_out", [512, 2048])
def test_resize_matches_repeat(n_out):
    """Resampling K sources into n != K destinations."""
    key = jax.random.key(3)
    lw = _log_weights("mild", N)
    xs = _leaf("wide", N)
    counts = systematic_offspring_counts(key, lw, n_out)
    want = jnp.repeat(xs, counts, axis=0, total_repeat_length=n_out)
    got = resample_tree(key, lw, xs, n_out)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


# Sizes spanning one and several thousand-element blocks, and one that is
# no power of two.
SIZES = [1000, 1 << 16, (1 << 16) + 128]


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("regime", ["uniform", "mild", "skewed", "one_hot",
                                    "head_tail"])
def test_offspring_cumulative_invariants(regime, n):
    """Nondecreasing, ends exactly at n, nonnegative counts summing to n."""
    cc = np.asarray(systematic_offspring_cumulative(
        jax.random.key(5), _log_weights(regime, n), n))
    assert cc.dtype == np.int32
    assert cc[-1] == n
    assert (np.diff(cc) >= 0).all()
    counts = np.diff(np.concatenate([[0], cc]))
    assert counts.sum() == n and (counts >= 0).all()


@pytest.mark.parametrize("n", SIZES)
def test_counts_proportional_to_weights(n):
    """Systematic counts are the floor or ceiling of n * w_i / sum(w)."""
    lw = jnp.log(jnp.arange(1, n + 1, dtype=jnp.float32))
    counts = np.asarray(systematic_offspring_counts(
        jax.random.key(9), lw, n), np.float64)
    w = np.arange(1, n + 1, dtype=np.float64)
    assert np.abs(counts - n * w / w.sum()).max() <= 1.0 + 1e-3


def test_late_spike_dominates():
    """A weight spike near the end of a long CDF takes its share and the
    partition stays valid."""
    n = 1 << 16
    lw = jnp.where(jnp.arange(n) == n - 7, 20.0, 0.0)
    counts = np.asarray(systematic_offspring_counts(jax.random.key(2), lw, n))
    assert counts.sum() == n
    assert counts[n - 7] > 0.9 * n


def test_cumulative_tail_exact_at_2_20():
    """f32 cumsum rounding at 2^20 would drop the final destination for
    about a quarter of seeds; the last entry is pinned to exactly n."""
    n = 1 << 20
    for seed in range(4):
        k = jax.random.key(seed)
        cc = systematic_offspring_cumulative(
            k, jax.random.normal(k, (n,)) * 2.0, n)
        assert int(cc[-1]) == n
        assert int(jnp.min(jnp.diff(cc))) >= 0
