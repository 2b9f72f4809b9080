import jax
import jax.numpy as jnp
import pytest
from jax.experimental import checkify

from genjax_xla.core.checks import do_checkify
from genjax_xla.gfi.mask import Mask
from genjax_xla.gfi.selection import Selection


class TestSelection:
    def test_all_none_leaf(self):
        assert Selection.all()["anything"] is True
        assert Selection.none()["anything"] is False
        leaf = Selection.leaf()
        assert leaf.check() is True
        assert leaf["deeper"] is False

    def test_at(self):
        sel = Selection.at["x", "y"]
        assert bool(sel["x", "y"])
        assert bool(sel["x", "y", "deeper"])  # whole subtree selected
        assert not bool(sel["x"])
        assert not bool(sel["z"])

    def test_complement(self):
        sel = ~Selection.at["x"]
        assert not bool(sel["x"])
        assert bool(sel["y"])
        assert (~sel)["x"], "double complement"

    def test_and_or(self):
        a = Selection.at["x"] | Selection.at["y"]
        assert bool(a["x"]) and bool(a["y"]) and not bool(a["z"])
        b = a & Selection.at["x"]
        assert bool(b["x"]) and not bool(b["y"])

    def test_wildcard(self):
        sel = Selection.at["outer", ..., "inner"]
        assert bool(sel["outer", "anything", "inner"])
        assert not bool(sel["outer", "anything", "other"])

    def test_extend(self):
        sel = Selection.at["y"].extend("x")
        assert bool(sel["x", "y"])
        assert not bool(sel["y"])

    def test_mask(self):
        sel = Selection.all().mask(False)
        assert sel["x"] is False
        sel = Selection.all().mask(True)
        assert sel["x"] is True
        traced = Selection.all().mask(jnp.asarray(True))
        assert bool(traced["x"])

    def test_dynamic_int_sel(self):
        sel = Selection.at[jnp.asarray(3), "x"]
        assert bool(sel[3, "x"])
        assert not bool(sel[2, "x"])


class TestMask:
    def test_build_nested(self):
        m = Mask.build(Mask.build(1.0, True), True)
        assert m.flag is True
        m2 = Mask.build(Mask.build(1.0, jnp.asarray(True)), False)
        assert m2.flag is False

    def test_maybe_mask(self):
        assert Mask.maybe_mask(1.0, True) == 1.0
        assert Mask.maybe_mask(1.0, False) is None
        m = Mask.maybe_mask(1.0, jnp.asarray(True))
        assert isinstance(m, Mask)

    def test_unmask_default(self):
        m = Mask(jnp.asarray([1.0, 2.0]), jnp.asarray(False))
        out = m.unmask(default=jnp.zeros(2))
        assert jnp.allclose(out, 0.0)

    def test_unmask_checkify(self):
        m = Mask(jnp.asarray(1.0), jnp.asarray(False))
        with do_checkify():

            def run():
                return m.unmask()

            err, _ = checkify.checkify(run)()
            with pytest.raises(Exception):
                err.throw()

    def test_or(self):
        a = Mask(jnp.asarray(1.0), jnp.asarray(False))
        b = Mask(jnp.asarray(2.0), jnp.asarray(True))
        out = a | b
        assert bool(out.flag)
        assert out.value == 2.0

    def test_or_prefers_left(self):
        a = Mask(jnp.asarray(1.0), jnp.asarray(True))
        b = Mask(jnp.asarray(2.0), jnp.asarray(True))
        assert (a | b).value == 1.0

    def test_xor(self):
        a = Mask(jnp.asarray(1.0), jnp.asarray(True))
        b = Mask(jnp.asarray(2.0), jnp.asarray(True))
        out = a ^ b
        assert not bool(out.flag)
        one = Mask(jnp.asarray(1.0), jnp.asarray(False)) ^ b
        assert bool(one.flag)
        assert one.value == 2.0

    def test_indexing(self):
        m = Mask(jnp.arange(4.0), jnp.asarray([True, False, True, False]))
        m1 = m[1]
        assert m1.value == 1.0
        assert not bool(m1.flag)
