import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import pytest

from genjax_xla.core.pytree import Closure, Const, Pytree, PythonicPytree


@Pytree.dataclass
class Point(Pytree):
    x: jax.Array
    y: jax.Array
    name: str = Pytree.static(default="p")


class TestPytreeDataclass:
    def test_flatten_split(self):
        p = Point(jnp.ones(3), jnp.zeros(3), name="q")
        leaves, treedef = jtu.tree_flatten(p)
        assert len(leaves) == 2
        p2 = jtu.tree_unflatten(treedef, leaves)
        assert p2.name == "q"

    def test_static_field_in_treedef(self):
        p1 = Point(jnp.ones(3), jnp.zeros(3), name="a")
        p2 = Point(jnp.ones(3), jnp.zeros(3), name="b")
        assert jtu.tree_structure(p1) != jtu.tree_structure(p2)

    def test_jit_through(self):
        @jax.jit
        def f(p: Point):
            return p.x + p.y

        p = Point(jnp.ones(3), jnp.full(3, 2.0))
        assert jnp.allclose(f(p), 3.0)

    def test_replace(self):
        p = Point(jnp.ones(3), jnp.zeros(3))
        q = p.replace(x=jnp.zeros(3))
        assert jnp.allclose(q.x, 0.0)
        assert jnp.allclose(p.x, 1.0)

    def test_tree_map(self):
        p = Point(jnp.ones(3), jnp.zeros(3))
        q = jtu.tree_map(lambda v: v + 1, p)
        assert jnp.allclose(q.x, 2.0)
        assert jnp.allclose(q.y, 1.0)


class TestConst:
    def test_const_no_leaves(self):
        c = Const(42)
        assert jtu.tree_leaves(c) == []

    def test_const_through_jit(self):
        @jax.jit
        def f(c: Const):
            return jnp.zeros(c.value)

        assert f(Const(4)).shape == (4,)

    def test_const_eq_hash(self):
        assert Const(3) == Const(3)
        assert hash(Const(3)) == hash(Const(3))
        assert Const(3) != Const(4)

    def test_unwrap(self):
        assert Const.unwrap(Const(3)) == 3
        assert Const.unwrap(5) == 5

    def test_tree_const(self):
        t = Pytree.tree_const({"a": 1, "b": 2})
        assert jtu.tree_leaves(t) == []
        u = Pytree.tree_const_unwrap(t)
        assert u == {"a": 1, "b": 2}


class TestClosure:
    def test_partial(self):
        @Pytree.partial(jnp.array(3.0))
        def add(x, y):
            return x + y

        assert isinstance(add, Closure)
        assert add(jnp.array(4.0)) == 7.0

    def test_closure_is_pytree(self):
        @Pytree.partial(jnp.array(3.0))
        def add(x, y):
            return x + y

        leaves = jtu.tree_leaves(add)
        assert len(leaves) == 1

        @jax.jit
        def run(c, v):
            return c(v)

        assert run(add, jnp.array(1.0)) == 4.0


@Pytree.dataclass
class Batch(PythonicPytree):
    a: jax.Array


class TestPythonicPytree:
    def test_index_len_iter_concat(self):
        b = Batch(jnp.arange(5.0))
        assert len(b) == 5
        assert b[2].a == 2.0
        assert [float(x.a) for x in b] == [0, 1, 2, 3, 4]
        c = b + b
        assert len(c) == 10
