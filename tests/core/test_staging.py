import jax
import jax.numpy as jnp
import pytest

from genjax_xla.core.compiler.staging import (
    FlagOp,
    empty_value,
    multi_switch,
    stage,
    to_shape_fn,
    tree_choose,
)


class TestStage:
    def test_stage_returns_jaxpr(self):
        def f(x):
            return x * 2.0

        closed_jaxpr, (in_tree, out_tree, out_shape) = stage(f)(jnp.ones(3))
        assert len(closed_jaxpr.jaxpr.invars) == 1
        assert out_shape.shape == (3,)


class TestFlagOp:
    def test_concrete_short_circuit(self):
        assert FlagOp.and_(True, False) is False
        assert FlagOp.and_(True, True) is True
        assert FlagOp.or_(False, True) is True
        assert FlagOp.not_(True) is False
        assert FlagOp.xor_(True, False) is True

    def test_mixed(self):
        t = jnp.asarray(True)
        assert FlagOp.and_(False, t) is False
        assert FlagOp.or_(True, t) is True
        # traced flags produce arrays
        assert bool(FlagOp.and_(True, t))
        assert bool(FlagOp.or_(False, t))

    def test_where_cond(self):
        assert FlagOp.where(True, 1.0, 2.0) == 1.0
        assert FlagOp.where(False, 1.0, 2.0) == 2.0
        out = FlagOp.where(jnp.asarray(True), jnp.asarray(1.0), jnp.asarray(2.0))
        assert out == 1.0
        assert FlagOp.cond(True, lambda x: x + 1, lambda x: x - 1, 1.0) == 2.0
        out = FlagOp.cond(
            jnp.asarray(False), lambda x: x + 1, lambda x: x - 1, 1.0
        )
        assert out == 0.0


class TestTreeChoose:
    def test_concrete_idx(self):
        out = tree_choose(1, [{"a": 1.0}, {"a": 2.0}])
        assert out["a"] == 2.0

    def test_traced_idx(self):
        @jax.jit
        def f(i):
            return tree_choose(i, [{"a": jnp.array(1.0)}, {"a": jnp.array(2.0)}])

        assert f(0)["a"] == 1.0
        assert f(1)["a"] == 2.0

    def test_dtype_promotion(self):
        out = tree_choose(jnp.asarray(0), [jnp.array(1), jnp.array(2)])
        assert out == 1


class TestMultiSwitch:
    def test_heterogeneous_shapes(self):
        def b0(x):
            return x + 1.0

        def b1(x):
            return jnp.stack([x, x])

        args = [(jnp.array(1.0),), (jnp.array(2.0),)]
        out = multi_switch(0, [b0, b1], args)
        assert out[0] == 2.0
        assert out[1].shape == (2,)
        assert jnp.allclose(out[1], 0.0)

        @jax.jit
        def f(i):
            return multi_switch(i, [b0, b1], args)

        out = f(1)
        assert out[0] == 0.0
        assert jnp.allclose(out[1], 2.0)


class TestShapeFns:
    def test_to_shape_fn(self):
        shape = to_shape_fn(lambda x: x * 2)(jnp.ones((3, 4)))
        assert shape.shape == (3, 4)

    def test_empty_value(self):
        v = empty_value(lambda x: {"y": x * 2}, jnp.ones(3))
        assert jnp.allclose(v["y"], 0.0)
