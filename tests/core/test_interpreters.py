import jax
import jax.numpy as jnp
import pytest

from genjax_xla.core.compiler.initial_style_primitive import (
    InitialStylePrimitive,
    initial_style_bind,
)
from genjax_xla.core.compiler.interpreters.incremental import (
    Diff,
    NoChange,
    UnknownChange,
    incremental,
)
from genjax_xla.core.compiler.interpreters.stateful import (
    StatefulHandler,
    stateful,
)


class TestInitialStylePrimitive:
    def test_bind_and_eval(self):
        prim = InitialStylePrimitive("my_op")

        def fn(x):
            return x * 3.0

        out = initial_style_bind(prim)(fn)(jnp.array(2.0))
        assert out == 6.0

    def test_under_jit_and_vmap(self):
        prim = InitialStylePrimitive("my_op2")

        def fn(x):
            return x * 3.0

        bound = initial_style_bind(prim)(fn)
        assert jax.jit(bound)(jnp.array(2.0)) == 6.0
        out = jax.vmap(bound)(jnp.arange(3.0))
        assert jnp.allclose(out, jnp.array([0.0, 3.0, 6.0]))

    def test_jvp(self):
        prim = InitialStylePrimitive("my_op3")

        def fn(x):
            return x * x

        bound = initial_style_bind(prim)(fn)
        y, t = jax.jvp(bound, (2.0,), (1.0,))
        assert y == 4.0
        assert t == 4.0


class CountMuls(StatefulHandler):
    def __init__(self):
        self.count = 0

    def handles(self, primitive):
        return primitive.name == "mul"

    def dispatch(self, primitive, *args, **params):
        self.count += 1
        return [primitive.bind(*args, **params)]


class TestStateful:
    def test_intercept(self):
        def f(x):
            return x * x + x * 3.0

        handler = CountMuls()
        out = stateful(f)(handler, jnp.array(2.0))
        assert out == 10.0
        assert handler.count == 2


class TestIncremental:
    def test_no_change_propagates(self):
        def f(x, y):
            return x + y, x * 2.0

        out = incremental(f)((1.0, 2.0), NoChange)
        assert Diff.static_check_no_change(out)
        assert Diff.tree_primal(out) == (3.0, 2.0)

    def test_unknown_change_propagates(self):
        def f(x, y):
            return x + y

        out = incremental(f)((1.0, 2.0), UnknownChange)
        assert not Diff.static_check_no_change(out)
        assert Diff.tree_primal(out) == 3.0

    def test_mixed_tangents(self):
        # Output depending only on unchanged input stays NoChange.
        def f(x, y):
            return x * 2.0, y * 3.0

        out = incremental(f)((1.0, 2.0), (NoChange, UnknownChange))
        a, b = out
        assert Diff.static_check_no_change(a)
        assert not Diff.static_check_no_change(b)

    def test_diff_constructors(self):
        d = Diff.no_change((1.0, {"a": 2.0}))
        assert Diff.static_check_no_change(d)
        assert Diff.tree_primal(d) == (1.0, {"a": 2.0})
        d2 = Diff.unknown_change(d)
        assert not Diff.static_check_no_change(d2)
        assert Diff.tree_primal(d2) == (1.0, {"a": 2.0})
