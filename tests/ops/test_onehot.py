"""Exact row/element selection from the HMM and SLDS tables by gather,
and the HMM bootstrap filter built on it vs the exact forward filter."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest


def _tables(dtype):
    """An (S, S) table with -inf entries (impossible transitions) and an
    (S,) column, as the HMM filter gathers them."""
    from genjax_xla.lang.distributions.discrete_hmm import (
        DiscreteHMMConfiguration,
    )

    logits = DiscreteHMMConfiguration.circulant(16, 16).transition_logits
    logits = jnp.where(jnp.abs(logits) > 6.0, -jnp.inf, logits)
    return logits.astype(dtype), logits[:, 3].astype(dtype)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_gather_selection_exact_with_neg_inf(dtype):
    """Row and element gathers return the table entries bit for bit,
    -inf included (a one-hot contraction would give 0 * -inf = NaN)."""
    table, col = _tables(dtype)
    assert bool(jnp.any(jnp.isneginf(table)))
    idx = jax.random.randint(jax.random.key(1), (1000,), 0, 16)
    rows = jax.jit(lambda t, i: t[i])(table, idx)
    elems = jax.jit(lambda c, i: c[i])(col, idx)
    t_np, c_np, i_np = np.asarray(table), np.asarray(col), np.asarray(idx)
    np.testing.assert_array_equal(np.asarray(rows), t_np[i_np])
    np.testing.assert_array_equal(np.asarray(elems), c_np[i_np])
    assert not np.isnan(np.asarray(rows, np.float32)).any()


def test_two_index_gather_matches_column_then_element():
    """``obs_logits[z, o]`` with a traced observation equals the column
    ``obs_logits[:, o]`` gathered at ``z``."""
    table, _ = _tables(jnp.float32)
    z = jax.random.randint(jax.random.key(2), (513,), 0, 16)
    for o in (0, 7, 15):
        got = jax.jit(lambda t, z, o: t[z, o])(table, z, o)
        np.testing.assert_array_equal(
            np.asarray(got), np.asarray(table)[:, o][np.asarray(z)]
        )


def test_invcdf_rows_never_pick_impossible_state():
    """Inverse-CDF sampling on gathered CDF rows of a table with
    impossible transitions never lands on one of them."""
    table, _ = _tables(jnp.float32)
    cdf = jnp.cumsum(jax.nn.softmax(table, axis=-1), axis=-1)
    zs = jax.random.randint(jax.random.key(3), (4096,), 0, 16)
    u = jax.random.uniform(jax.random.key(4), (4096, 1))
    z_new = jnp.minimum(jnp.sum(cdf[zs] < u, axis=-1), 15)
    picked = np.asarray(table)[np.asarray(zs), np.asarray(z_new)]
    assert np.isfinite(picked).all()


def test_hmm_bootstrap_filter_logz():
    from genjax_xla.lang.distributions.discrete_hmm import (
        DiscreteHMMConfiguration, forward_filter,
    )
    from genjax_xla.inference.exact_testbed import sample_problem
    from genjax_xla.models import hmm_bootstrap_filter

    S, T = 16, 24
    config = DiscreteHMMConfiguration.circulant(S, S)
    problem = sample_problem(jax.random.key(3), config, T)
    obs = problem.observations
    _, exact = forward_filter(config, obs)

    run = hmm_bootstrap_filter(config, 4096)
    fs, _ = jax.jit(run)(jax.random.key(5), obs)
    assert abs(float(fs.log_z) - float(exact)) < 0.25


def test_hmm_bootstrap_filter_sharded_bitwise():
    """The HMM filter under a mesh sharding constraint:
    same bits as the unsharded run (batched path: one key per step, so
    ensemble values are layout-independent), particles spread over the
    virtual 8-device mesh."""
    import numpy as np

    from genjax_xla.lang.distributions.discrete_hmm import (
        DiscreteHMMConfiguration,
    )
    from genjax_xla.inference.exact_testbed import sample_problem
    from genjax_xla.models import hmm_bootstrap_filter
    from genjax_xla.parallel.mesh import particle_mesh, shard_leading_axis

    S, T, P = 16, 12, 1024
    config = DiscreteHMMConfiguration.circulant(S, S)
    obs = sample_problem(jax.random.key(3), config, T).observations

    run_plain = hmm_bootstrap_filter(config, P)
    fs0, lz0 = jax.jit(run_plain)(jax.random.key(5), obs)

    mesh = particle_mesh()
    run_sharded = hmm_bootstrap_filter(
        config, P,
        shard_constraint=lambda t: shard_leading_axis(
            t, mesh, "particles"
        ),
    )
    fs1, lz1 = jax.jit(run_sharded)(jax.random.key(5), obs)

    np.testing.assert_array_equal(
        np.asarray(fs0.log_z), np.asarray(fs1.log_z)
    )
    np.testing.assert_array_equal(
        np.asarray(fs0.particles), np.asarray(fs1.particles)
    )
    shards = {sh.device for sh in fs1.particles.addressable_shards}
    assert len(shards) == len(jax.devices())


def test_hmm_bootstrap_filter_gumbel_path_logz():
    """Both transition samplers target the same law: the gumbel
    (categorical) path also matches the exact forward filter."""
    from genjax_xla.lang.distributions.discrete_hmm import (
        DiscreteHMMConfiguration, forward_filter,
    )
    from genjax_xla.inference.exact_testbed import sample_problem
    from genjax_xla.models import hmm_bootstrap_filter

    S, T = 16, 24
    config = DiscreteHMMConfiguration.circulant(S, S)
    obs = sample_problem(jax.random.key(3), config, T).observations
    _, exact = forward_filter(config, obs)
    run = hmm_bootstrap_filter(config, 4096, sampling="gumbel")
    fs, _ = jax.jit(run)(jax.random.key(5), obs)
    assert abs(float(fs.log_z) - float(exact)) < 0.25

    import pytest
    with pytest.raises(ValueError, match="sampling"):
        hmm_bootstrap_filter(config, 64, sampling="nope")
