"""Key-dependency taint analysis (core/compiler/taint.py) and its use
for invariant-leaf skipping in trace resampling."""

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np

import genjax_xla as g
from genjax_xla.core.compiler.taint import variant_leaf_mask
from genjax_xla.inference import Target
from genjax_xla.inference.smc import resample_tree


def test_basic_mask():
    c = jnp.arange(4.0)

    def fn(key, x):
        a = jax.random.normal(key, (3,))
        b = x + 1.0
        d = c * 2.0          # depends on a closed-over const only
        return {"a": a, "b": b, "d": d, "mix": b + a.sum()}

    mask = variant_leaf_mask(fn, jax.random.key(0), jnp.ones(3))
    assert mask == {"a": True, "b": False, "d": False, "mix": True}


def test_argnum_selects_tainted_argument():
    def fn(x, key):
        return x * 2.0, jax.random.uniform(key, ())

    m0 = variant_leaf_mask(fn, jnp.ones(2), jax.random.key(0), argnum=1)
    assert m0 == (False, True)
    m1 = variant_leaf_mask(fn, jnp.ones(2), jax.random.key(0), argnum=0)
    assert m1 == (True, False)


def test_conservative_through_scan_and_cond():
    def fn(key, x):
        def body(c, _):
            return c + 1.0, None

        # Taint enters the scan carry -> its outputs are tainted.
        z0 = jax.random.normal(key, ())
        z, _ = jax.lax.scan(body, z0, jnp.arange(3))
        w = jax.lax.cond(x[0] > 0, lambda v: v, lambda v: -v, x.sum())
        return z, w

    mask = variant_leaf_mask(fn, jax.random.key(0), jnp.ones(2))
    assert mask == (True, False)


def test_trace_constraint_leaves_are_invariant():
    """The constrained observation values inside an importance trace
    must be recognized as key-independent (this is what makes the
    resample skip fire)."""
    ys = jnp.linspace(-1.0, 1.0, 32)

    @g.gen
    def model():
        mu = g.normal(0.0, 3.0) @ "mu"
        _ = g.mv_normal_diag(mu * jnp.ones(32), jnp.ones(32)) @ "ys"

    target = Target(model, (), g.C["ys"].set(ys))

    def per_particle(k):
        tr, _ = target.importance(k, g.ChoiceMap.empty())
        return tr

    mask = variant_leaf_mask(per_particle, jax.random.key(0))
    flat, _ = jtu.tree_flatten(mask)
    tr = per_particle(jax.random.key(0))
    leaves = jtu.tree_leaves(tr)
    # The wide (32,) observation-value leaf must be invariant; the
    # sampled latent must be variant.
    wide_invariant = [
        not v for v, l in zip(flat, leaves)
        if hasattr(l, "shape") and l.shape == (32,)
    ]
    assert any(wide_invariant)
    assert any(flat)  # something IS key-dependent (the latent, scores)


def test_resample_tree_invariant_bitwise():
    n = 64
    k = jax.random.key(1)
    lw = jax.random.normal(k, (n,))
    tree = {
        "latent": jax.random.normal(jax.random.key(2), (n,)),
        "obs": jnp.broadcast_to(jnp.arange(8.0), (n, 8)) + 0.0,
    }
    full = resample_tree(k, lw, tree, n)
    skipped = resample_tree(
        k, lw, tree, n, invariant={"latent": False, "obs": True}
    )
    np.testing.assert_array_equal(
        np.asarray(full["latent"]), np.asarray(skipped["latent"])
    )
    # obs rows are identical across particles, so skipping is lossless.
    np.testing.assert_array_equal(
        np.asarray(full["obs"]), np.asarray(skipped["obs"])
    )


def test_tempered_smc_unchanged_by_skip(monkeypatch):
    """Wired-in skip must not change any sampler output bitwise (the
    skipped leaves are constant across particles)."""
    from genjax_xla.inference import smc_sampler

    ys = 0.5 + 0.3 * jax.random.normal(jax.random.key(0), (16,))

    @g.gen
    def model():
        mu = g.normal(0.0, 2.0) @ "mu"
        _ = g.mv_normal_diag(mu * jnp.ones(16), jnp.ones(16)) @ "ys"

    target = Target(model, (), g.C["ys"].set(ys))

    run = smc_sampler.tempered_smc(target, 256, n_temps=6, n_moves=1)
    res = jax.jit(run)(jax.random.key(7))

    # Disable the analysis (mark everything variant) and re-run.
    real = smc_sampler.variant_leaf_mask

    def all_variant(fn, *args, **kw):
        return jtu.tree_map(lambda _: True, real(fn, *args, **kw))

    monkeypatch.setattr(smc_sampler, "variant_leaf_mask", all_variant)
    run2 = smc_sampler.tempered_smc(target, 256, n_temps=6, n_moves=1)
    res2 = jax.jit(run2)(jax.random.key(7))

    np.testing.assert_array_equal(
        np.asarray(res.log_z), np.asarray(res2.log_z)
    )
    for a, b in zip(jtu.tree_leaves(res.traces),
                    jtu.tree_leaves(res2.traces)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
