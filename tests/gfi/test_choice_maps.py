import jax
import jax.numpy as jnp
import pytest

from genjax_xla.gfi.choice_map import (
    C,
    ChoiceMap,
    ChoiceMapNoValueAtAddress,
)
from genjax_xla.gfi.mask import Mask
from genjax_xla.gfi.selection import Selection


class TestConstruction:
    def test_choice(self):
        chm = ChoiceMap.choice(42)
        assert chm.get_value() == 42
        assert chm.has_value()

    def test_entry(self):
        chm = ChoiceMap.entry(3.0, "x", "y")
        assert chm["x", "y"] == 3.0
        assert chm("x")("y").get_value() == 3.0

    def test_d(self):
        chm = ChoiceMap.d({"x": 1, ("y", "z"): 2.0})
        assert chm["x"] == 1
        assert chm["y", "z"] == 2.0

    def test_kw(self):
        chm = ChoiceMap.kw(x=1.0, y=2.0)
        assert chm["x"] == 1.0
        assert chm["y"] == 2.0

    def test_builder(self):
        chm = C["x", "y"].set(3.0)
        assert chm["x", "y"] == 3.0

    def test_at_update(self):
        chm = ChoiceMap.d({("x", "y"): 3.0, "z": 12.0})
        updated = chm.at["x", "y"].set(4.0)
        assert updated["x", "y"] == 4.0
        assert updated["z"] == 12.0

    def test_missing_raises(self):
        chm = ChoiceMap.d({"x": 1})
        with pytest.raises(ChoiceMapNoValueAtAddress):
            chm["nope"]

    def test_contains(self):
        chm = ChoiceMap.d({"x": 1})
        assert "x" in chm
        assert "y" not in chm

    def test_empty(self):
        assert ChoiceMap.empty().static_is_empty()
        assert not ChoiceMap.d({"x": 1}).static_is_empty()


class TestMergeAndFilter:
    def test_or_priority(self):
        a = ChoiceMap.d({"x": 1.0})
        b = ChoiceMap.d({"x": 2.0, "y": 3.0})
        merged = a | b
        assert merged["x"] == 1.0
        assert merged["y"] == 3.0

    def test_and(self):
        a = ChoiceMap.d({"x": 1.0})
        b = ChoiceMap.d({"x": 2.0, "y": 3.0})
        both = a & b
        assert both["x"] == 2.0
        assert "y" not in both

    def test_filter_static(self):
        chm = ChoiceMap.d({"x": 1.0, "y": 2.0})
        f = chm.filter(Selection.at["x"])
        assert f["x"] == 1.0
        assert "y" not in f

    def test_filter_complement(self):
        chm = ChoiceMap.d({"x": 1.0, "y": 2.0})
        f = chm.filter(~Selection.at["x"])
        assert "x" not in f
        assert f["y"] == 2.0

    def test_mask_concrete(self):
        chm = ChoiceMap.choice(42)
        assert chm.mask(True).get_value() == 42
        assert chm.mask(False).get_value() is None

    def test_mask_traced(self):
        chm = ChoiceMap.choice(jnp.asarray(42.0))
        m = chm.mask(jnp.asarray(True)).get_value()
        assert isinstance(m, Mask)
        assert m.unmask() == 42.0

    def test_extend(self):
        chm = ChoiceMap.choice(42).extend("x")
        assert chm["x"] == 42

    def test_get_selection(self):
        chm = ChoiceMap.d({"x": 1.0})
        sel = chm.get_selection()
        assert sel["x"] is True or bool(sel["x"])
        assert not bool(sel["y"])


class TestSwitch:
    def test_switch_concrete(self):
        chm1 = ChoiceMap.d({"x": 1.0})
        chm2 = ChoiceMap.d({"x": 3.0})
        out = ChoiceMap.switch(1, [chm1, chm2])
        assert out["x"] == 3.0

    def test_switch_traced(self):
        chm1 = ChoiceMap.d({"x": 1.0, "y": 2.0})
        chm2 = ChoiceMap.d({"x": 3.0, "y": 4.0})
        out = ChoiceMap.switch(jnp.asarray(1), [chm1, chm2])
        assert out["x"].unmask() == 3.0
        assert out["y"].unmask() == 4.0


class TestIndexed:
    def test_scalar_dynamic_extend(self):
        chm = ChoiceMap.entry(5.0, jnp.asarray(3))
        got = chm.get_submap(3).get_value()
        assert Mask.build(got).unmask() == 5.0
        missing = chm.get_submap(2).get_value()
        if missing is not None:
            flag = Mask.build(missing).primal_flag()
            assert not bool(jnp.all(jnp.asarray(flag)))

    def test_vmap_constructed(self):
        vec_chm = jax.vmap(lambda idx, v: C["x", idx].set(v))(
            jnp.arange(10), jnp.arange(10.0) * 2
        )
        sub = vec_chm.get_submap("x", 3).get_value()
        assert Mask.build(sub).unmask() == 6.0

    def test_vmap_constructed_missing(self):
        vec_chm = jax.vmap(lambda idx, v: C["x", idx].set(v))(
            jnp.arange(5) * 2, jnp.arange(5.0)
        )
        sub = vec_chm.get_submap("x", 3).get_value()  # odd idx: missing
        # Concrete lookups fold the miss to a static absence (None); traced
        # lookups yield a False-flagged Mask. Both mean "missing".
        if sub is not None:
            flag = Mask.build(sub).primal_flag()
            assert not bool(jnp.all(jnp.asarray(flag)))

        # Under jit the lookup is traced: must be a masked-out value.
        @jax.jit
        def lookup(chm, i):
            v = chm.get_submap("x", i).get_value()
            m = Mask.build(v)
            return m.primal_flag()

        assert not bool(lookup(vec_chm, 3))
        assert bool(lookup(vec_chm, 4))


class TestJitCompat:
    def test_chm_through_jit(self):
        @jax.jit
        def f(chm):
            return chm["x"] + 1.0

        assert f(ChoiceMap.d({"x": jnp.asarray(1.0)})) == 2.0

    def test_filter_through_jit(self):
        @jax.jit
        def f(chm, flag):
            m = chm.mask(flag).get_value()
            return m.unmask(default=jnp.asarray(-1.0))

        chm = ChoiceMap.choice(jnp.asarray(5.0))
        assert f(chm, jnp.asarray(True)) == 5.0
        assert f(chm, jnp.asarray(False)) == -1.0


class TestInvalidSubset:
    def test_detects_typo(self):
        import genjax_xla as g

        @g.gen
        def model():
            x = g.normal(0.0, 1.0) @ "x"
            return x

        bad = g.C["x"].set(1.0) | g.C["tpyo"].set(2.0)
        invalid = bad.invalid_subset(model, ())
        assert invalid is not None
        assert invalid["tpyo"] == 2.0

    def test_all_valid_returns_none(self):
        import genjax_xla as g

        @g.gen
        def model():
            x = g.normal(0.0, 1.0) @ "x"
            y = g.normal(x, 1.0) @ "y"
            return y

        ok = g.C["x"].set(1.0) | g.C["y"].set(0.5)
        assert ok.invalid_subset(model, ()) is None


class TestLanesLeading:
    def test_vmapped_scan_choices_lane_lookup(self):
        """A choice map returned through vmap has batch axes in front of
        the Indexed lane axis; ``lanes_leading`` restores lane-first
        layout so integer address lookup picks steps, not batch lanes."""
        import jax
        import jax.numpy as jnp

        import genjax_xla as g
        from genjax_xla.gfi.choice_map import lanes_leading

        T, B = 5, 3

        @g.gen
        def step(carry, _):
            x = g.normal(carry, 1.0) @ "x"
            return x, None

        @g.gen
        def model(shift):
            _ = step.scan(n=T)(shift, None) @ "chain"
            _ = g.normal(shift, 1.0) @ "flat"

        def choices(seed):
            tr = model.simulate(jax.random.key(0), (seed,))
            return tr.get_choices()

        batched = jax.vmap(choices)(jnp.arange(float(B)))
        fixed = lanes_leading(batched, 1)

        single = choices(jnp.asarray(2.0))
        for t in range(T):
            lane = jnp.asarray(fixed["chain", t, "x"])
            assert lane.shape == (B,), lane.shape
            # batch entry 2 of step t must equal the unbatched run's step t
            assert jnp.allclose(lane[2], single["chain", t, "x"])
        # flat (non-Indexed) sites keep the leading batch axis
        assert jnp.shape(fixed["flat"]) == (B,)
        assert jnp.allclose(
            jnp.asarray(fixed["flat"])[2], single["flat"]
        )


class TestFullSliceBuilder:
    """``C[:].set(...)`` — the full slice addresses all lanes (parity:
    reference ``tests/core/test_choice_maps.py`` ``test_choicemap_slice``
    / ``test_filtered_chm_update``)."""

    def test_build_and_read(self):
        xs = jnp.arange(4.0)
        c = C[:].set({"x": xs})
        assert jnp.array_equal(c[:, "x"], xs)
        assert float(c[2, "x"]) == 2.0

    def test_stepped_slice_rejected(self):
        with pytest.raises(ValueError, match="full slice"):
            C[::2].set({"x": jnp.arange(4.0)})
        with pytest.raises(ValueError, match="full slice"):
            C[1:3].set({"x": jnp.arange(4.0)})

    def test_filtered_chm_update(self):
        """Filter a full-slice constraint to one address and Update a
        repeat-model trace with it: only the selected address moves
        (parity: reference ``test_filtered_chm_update``)."""
        import genjax_xla as g

        @g.gen
        def f():
            x = g.normal(0.0, 1.0) @ "x"
            y = g.normal(10.0, 1.0) @ "y"
            return x, y

        tr = f.repeat(n=4).simulate(jax.random.key(0), ())
        xs, ys = jnp.ones(4), 5 * jnp.ones(4)
        c = C[:].set({"x": xs, "y": ys})

        only_xs = c.filter(Selection.at[..., "x"])
        new_tr, w, _, _ = tr.update(jax.random.key(1), only_xs)
        nc = new_tr.get_choices()
        assert jnp.array_equal(nc[:, "x"], xs)
        assert not jnp.array_equal(nc[:, "y"], ys)
        assert jnp.allclose(
            w, new_tr.get_score() - tr.get_score(), atol=1e-5
        )

        only_ys = c.filter(Selection.at[..., "y"])
        new_tr2, _, _, _ = tr.update(jax.random.key(2), only_ys)
        nc2 = new_tr2.get_choices()
        assert jnp.array_equal(nc2[:, "y"], ys)
        assert not jnp.array_equal(nc2[:, "x"], xs)


class TestSplitPathProperties:
    """get_submap path-splitting laws (parity: reference hypothesis
    tests ``test_get_submap_split_path`` / ``test_path_can_be_splat``)."""

    MAPPING = {
        "a": 1.0,
        ("b", "c"): 2.0,
        ("b", "d", "e"): 3.0,
        ("f", "g"): 4.0,
    }

    def _paths(self):
        return [
            (("a",), 1.0),
            (("b", "c"), 2.0),
            (("b", "d", "e"), 3.0),
            (("f", "g"), 4.0),
        ]

    def test_get_submap_split_path(self):
        chm = ChoiceMap.d(self.MAPPING)
        for path, value in self._paths():
            for i in range(len(path) + 1):
                got = chm.get_submap(*path[:i])[path[i:]] \
                    if path[i:] else chm.get_submap(*path[:i]).get_value()
                assert got == value, (path, i)

    def test_path_can_be_splat(self):
        chm = ChoiceMap.d(self.MAPPING)
        for path, value in self._paths():
            a = chm.get_submap(*path)
            b = chm
            for comp in path:
                b = b.get_submap(comp)
            assert a.get_value() == b.get_value() == value


class TestChoiceDynamicIndexLaws:
    """Laws of dynamic indexing on bare Choice values (hypothesis-lite:
    exhaustive over small shapes and node compositions)."""

    def test_slicing_law(self):
        arr = jnp.arange(12.0).reshape(4, 3)
        chm = ChoiceMap.choice(arr)
        for i in range(4):
            assert jnp.array_equal(
                chm.get_submap(i).get_value(), arr[i]
            )
        # traced index
        got = jax.jit(lambda j: chm.get_submap(j).get_value())(2)
        assert jnp.array_equal(got, arr[2])

    def test_string_lookup_is_empty(self):
        chm = ChoiceMap.choice(jnp.arange(4.0))
        assert chm.get_submap("x").static_is_empty()

    def test_composes_under_or_and_switch(self):
        a = ChoiceMap.choice(jnp.arange(4.0))
        b = ChoiceMap.entry(jnp.ones(4), jnp.arange(4), "x")
        merged = a | b
        assert float(merged.get_submap(2).get_value()) == 2.0
        sw = ChoiceMap.switch(jnp.asarray(0), [a, ChoiceMap.choice(-jnp.arange(4.0))])
        v = sw.get_submap(3).get_value()
        v = v.unmask() if isinstance(v, Mask) else v
        assert float(v) == 3.0

    def test_full_slice_identity(self):
        arr = jnp.arange(4.0)
        chm = ChoiceMap.choice(arr)
        assert jnp.array_equal(
            chm.get_submap(slice(None)).get_value(), arr
        )
        with pytest.raises(ValueError, match="full slice"):
            chm.get_submap(slice(0, 2))


def test_invalid_subset_accepts_vmap_constraints():
    """Lane-membership masks from valid dynamic-index constraints are
    not 'typos' (review finding: concrete all-False masks previously
    reported as invalid values)."""
    import genjax_xla as g

    @g.gen
    def kernel(mu):
        return g.normal(mu, 1.0) @ "x"

    vm = kernel.vmap(in_axes=0)
    c = C[:].set({"x": jnp.arange(4.0)})
    assert c.invalid_subset(vm, (jnp.zeros(4),)) is None
    # an actual typo is still caught
    bad = C[:].set({"z": jnp.arange(4.0)})
    assert bad.invalid_subset(vm, (jnp.zeros(4),)) is not None


class TestLanesLeadingExplicitIdx:
    """lanes_leading through EXPLICIT-idx Indexed nodes under vmap
    (VERDICT r2 item 7; round 2 raised NotImplementedError)."""

    def test_explicit_idx_vmap_roundtrip(self):
        import numpy as np
        from genjax_xla.gfi.choice_map import (
            Choice,
            Indexed,
            lanes_leading,
        )

        def make(k):
            return Indexed(
                Choice(jax.random.normal(k, (3, 2))),
                jnp.array([5, 7, 9]),
            )

        keys = jax.random.split(jax.random.key(1), 6)
        batched = jax.vmap(make)(keys)
        fixed = lanes_leading(batched, 1)
        # Address 7 is lane 1: value shape (batch, event) after the
        # lane axis moves in front.
        v = fixed[7]
        val = v.value if hasattr(v, "value") else v
        assert np.asarray(val).shape == (6, 2)
        want = jax.vmap(lambda k: jax.random.normal(k, (3, 2))[1])(keys)
        np.testing.assert_array_equal(np.asarray(val), np.asarray(want))

    def test_unbatched_explicit_idx_untouched(self):
        from genjax_xla.gfi.choice_map import (
            Choice,
            Indexed,
            lanes_leading,
        )

        chm = Indexed(
            Choice(jnp.arange(6.0).reshape(3, 2)), jnp.array([4, 5, 6])
        )
        # No batch axes on idx (ndim == 1 < batch_ndim+1): unchanged.
        out = lanes_leading(chm, 1)
        assert jnp.shape(out.idx) == (3,)

    def test_varying_concrete_idx_raises(self):
        """A hand-stacked Indexed whose addresses genuinely differ per
        batch entry must raise, not silently retarget every lane to
        batch entry 0's addresses (ADVICE r3)."""
        from genjax_xla.gfi.choice_map import (
            Choice,
            Indexed,
            lanes_leading,
        )

        chm = Indexed(
            Choice(jnp.zeros((2, 3, 2))),
            jnp.array([[1, 2, 3], [4, 5, 6]]),
        )
        with pytest.raises(ValueError, match="vary across the batch"):
            lanes_leading(chm, 1)

    def test_invariant_concrete_idx_collapses(self):
        from genjax_xla.gfi.choice_map import (
            Choice,
            Indexed,
            lanes_leading,
        )

        chm = Indexed(
            Choice(jnp.zeros((2, 3, 2))),
            jnp.array([[1, 2, 3], [1, 2, 3]]),
        )
        out = lanes_leading(chm, 1)
        assert jnp.shape(out.idx) == (3,)
