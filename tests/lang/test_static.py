"""GFI contract tests for the ``@gen`` static DSL.

Mirrors the reference's test strategy (SURVEY §4.2):
``/root/reference/tests/generative_functions/test_static_gen_fn.py`` —
score/weight identities against hand-computed log-densities, address-reuse
errors, update weight correctness.
"""

import jax
import jax.numpy as jnp
import jax.scipy.stats as jss
import pytest

import genjax_xla as g

KEY = jax.random.key(314159)


@g.gen
def two_normals(mu):
    x = g.normal(mu, 1.0) @ "x"
    y = g.normal(x, 0.1) @ "y"
    return y


class TestSimulate:
    def test_score_is_joint_logpdf(self):
        tr = two_normals.simulate(KEY, (0.5,))
        chm = tr.get_choices()
        x, y = chm["x"], chm["y"]
        expected = jss.norm.logpdf(x, 0.5, 1.0) + jss.norm.logpdf(y, x, 0.1)
        assert jnp.allclose(tr.get_score(), expected)

    def test_retval(self):
        tr = two_normals.simulate(KEY, (0.5,))
        assert jnp.allclose(tr.get_retval(), tr.get_choices()["y"])

    def test_jit(self):
        tr = jax.jit(two_normals.simulate)(KEY, (0.5,))
        expected = two_normals.simulate(KEY, (0.5,))
        assert jnp.allclose(tr.get_score(), expected.get_score())

    def test_vmap(self):
        keys = jax.random.split(KEY, 8)
        trs = jax.vmap(two_normals.simulate, in_axes=(0, None))(keys, (0.5,))
        assert trs.get_score().shape == (8,)
        # Lane 3 equals a standalone run with the same key.
        tr3 = two_normals.simulate(keys[3], (0.5,))
        assert jnp.allclose(trs.get_score()[3], tr3.get_score())

    def test_address_reuse_raises(self):
        @g.gen
        def bad():
            _ = g.normal(0.0, 1.0) @ "x"
            return g.normal(0.0, 1.0) @ "x"

        with pytest.raises(g.AddressReuse):
            bad.simulate(KEY, ())

    def test_nested_gen_fns(self):
        @g.gen
        def inner(mu):
            return g.normal(mu, 1.0) @ "z"

        @g.gen
        def outer():
            a = inner(0.0) @ "a"
            b = inner(a) @ "b"
            return b

        tr = outer.simulate(KEY, ())
        chm = tr.get_choices()
        a, b = chm["a", "z"], chm["b", "z"]
        expected = jss.norm.logpdf(a, 0.0, 1.0) + jss.norm.logpdf(b, a, 1.0)
        assert jnp.allclose(tr.get_score(), expected)


class TestAssess:
    def test_matches_simulate_score(self):
        tr = two_normals.simulate(KEY, (0.5,))
        score, retval = two_normals.assess(tr.get_choices(), (0.5,))
        assert jnp.allclose(score, tr.get_score())
        assert jnp.allclose(retval, tr.get_retval())

    def test_missing_address_raises(self):
        with pytest.raises(g.MissingAddress):
            two_normals.assess(g.C["x"].set(1.0), (0.5,))


class TestGenerate:
    def test_full_constraint_weight_is_score(self):
        chm = g.C["x"].set(1.0) | g.C["y"].set(1.1)
        tr, w = two_normals.generate(KEY, chm, (0.5,))
        assert jnp.allclose(w, tr.get_score())

    def test_partial_constraint_weight(self):
        tr, w = two_normals.generate(KEY, g.C["y"].set(1.0), (0.5,))
        x = tr.get_choices()["x"]
        assert jnp.allclose(w, jss.norm.logpdf(1.0, x, 0.1))

    def test_empty_constraint_weight_zero(self):
        tr, w = two_normals.generate(KEY, g.ChoiceMap.empty(), (0.5,))
        assert jnp.allclose(w, 0.0)


class TestUpdate:
    def test_weight_is_score_delta_full_reuse(self):
        tr = two_normals.simulate(KEY, (0.5,))
        new_tr, w, _rd, discard = tr.update(
            jax.random.key(1), g.C["x"].set(0.0)
        )
        # All randomness retained or constrained: w = s' - s.
        assert jnp.allclose(w, new_tr.get_score() - tr.get_score())
        assert jnp.allclose(discard["x"], tr.get_choices()["x"])
        assert jnp.allclose(new_tr.get_choices()["x"], 0.0)
        # y retained:
        assert jnp.allclose(
            new_tr.get_choices()["y"], tr.get_choices()["y"]
        )

    def test_update_roundtrip_weight_antisymmetry(self):
        # fwd then bwd update returns to the original trace; weights cancel.
        tr = two_normals.simulate(KEY, (0.5,))
        new_tr, w_fwd, _, discard = tr.update(
            jax.random.key(1), g.C["x"].set(0.0)
        )
        back_tr, w_bwd, _, _ = new_tr.update(jax.random.key(2), discard)
        assert jnp.allclose(w_fwd + w_bwd, 0.0, atol=1e-5)
        assert jnp.allclose(back_tr.get_score(), tr.get_score())

    def test_argdiff_update(self):
        tr = two_normals.simulate(KEY, (0.5,))
        argdiffs = (g.Diff(1.5, g.UnknownChange),)
        new_tr, w, _, _ = tr.update(
            jax.random.key(1), g.ChoiceMap.empty(), argdiffs
        )
        assert jnp.allclose(w, new_tr.get_score() - tr.get_score())
        x = tr.get_choices()["x"]
        assert jnp.allclose(
            w, jss.norm.logpdf(x, 1.5, 1.0) - jss.norm.logpdf(x, 0.5, 1.0)
        )


class TestRegenerate:
    def test_regenerate_weight_identity(self):
        tr = two_normals.simulate(KEY, (0.5,))
        rtr, w, _, _ = tr.edit(jax.random.key(7), g.Regenerate(g.S.at["x"]))
        chm, rchm = tr.get_choices(), rtr.get_choices()
        # y retained; x resampled from prior => w = logpdf(y; x', .1) -
        # logpdf(y; x, .1).
        assert jnp.allclose(rchm["y"], chm["y"])
        expected = jss.norm.logpdf(chm["y"], rchm["x"], 0.1) - jss.norm.logpdf(
            chm["y"], chm["x"], 0.1
        )
        assert jnp.allclose(w, expected, atol=1e-5)

    def test_regenerate_none_is_noop(self):
        tr = two_normals.simulate(KEY, (0.5,))
        rtr, w, _, _ = tr.edit(jax.random.key(7), g.Regenerate(g.S.none()))
        assert jnp.allclose(w, 0.0)
        assert jnp.allclose(rtr.get_choices()["x"], tr.get_choices()["x"])


class TestProject:
    def test_project_all_is_score(self):
        tr = two_normals.simulate(KEY, (0.5,))
        w = tr.project(jax.random.key(1), g.S.all())
        assert jnp.allclose(w, tr.get_score())

    def test_project_subset(self):
        tr = two_normals.simulate(KEY, (0.5,))
        w = tr.project(jax.random.key(1), g.S.at["x"])
        x = tr.get_choices()["x"]
        assert jnp.allclose(w, jss.norm.logpdf(x, 0.5, 1.0))


class TestSugar:
    def test_inline(self):
        @g.gen
        def inner(mu):
            return g.normal(mu, 1.0) @ "z"

        @g.gen
        def outer():
            return inner.inline(1.0)

        tr = outer.simulate(KEY, ())
        assert jnp.allclose(
            tr.get_score(), jss.norm.logpdf(tr.get_choices()["z"], 1.0, 1.0)
        )

    def test_partial_apply(self):
        fixed = two_normals.partial_apply(0.5)
        tr = fixed.simulate(KEY, ())
        ref = two_normals.simulate(KEY, (0.5,))
        assert jnp.allclose(tr.get_score(), ref.get_score())

    def test_get_zero_trace(self):
        ztr = two_normals.get_zero_trace(0.5)
        assert jnp.allclose(ztr.get_score(), 0.0)
        assert jnp.allclose(ztr.get_choices()["x"], 0.0)


class TestRequestVocabulary:
    def test_empty_request_replays_under_new_args(self):
        tr = two_normals.simulate(KEY, (0.5,))
        argdiffs = (g.Diff(1.0, g.UnknownChange),)
        new_tr, w, _, _ = g.EmptyRequest().edit(
            jax.random.key(1), tr, argdiffs
        )
        x = tr.get_choices()["x"]
        want = jss.norm.logpdf(x, 1.0, 1.0) - jss.norm.logpdf(x, 0.5, 1.0)
        assert jnp.allclose(w, want, atol=1e-6)
        assert jnp.allclose(new_tr.get_choices()["x"], x)

    def test_diff_annotate_coerces(self):
        tr = two_normals.simulate(KEY, (0.5,))
        # Coerce unknown argdiffs to no-change: weight must then be 0 for
        # an empty update.
        req = g.DiffAnnotate(
            g.Update(g.ChoiceMap.empty()),
            argdiff_fn=lambda d: g.Diff.no_change(d),
        )
        argdiffs = (g.Diff(0.9, g.UnknownChange),)
        _, w, _, _ = req.edit(jax.random.key(1), tr, argdiffs)
        assert jnp.allclose(w, 0.0)

    def test_static_request_per_address(self):
        tr = two_normals.simulate(KEY, (0.5,))
        req = g.StaticRequest({
            "x": g.Regenerate(g.S.all()),
            "y": g.Update(g.ChoiceMap.empty()),
        })
        new_tr, w, _, bwd = tr.edit(jax.random.key(9), req)
        assert isinstance(bwd, g.StaticRequest)
        # y retained, x resampled:
        assert jnp.allclose(
            new_tr.get_choices()["y"], tr.get_choices()["y"]
        )
        assert float(new_tr.get_choices()["x"]) != float(
            tr.get_choices()["x"]
        )


class TestSampleShape:
    """Parity: reference ``test_static_sample_shape`` — the
    ``sample_shape=`` kwarg draws an iid block as one choice."""

    def test_iid_block_shape_and_score(self):
        @g.gen
        def f():
            return g.normal(
                0.0, 1.0, sample_shape=g.Const((2, 2))
            ) @ "normal"

        tr = f.simulate(jax.random.key(0), ())
        v = tr.get_choices()["normal"]
        assert tr.get_retval().shape == (2, 2)
        assert v.shape == (2, 2)
        want = jnp.sum(jss.norm.logpdf(v, 0.0, 1.0))
        assert jnp.allclose(tr.get_score(), want, atol=1e-6)

    def test_iid_assess_and_generate(self):
        @g.gen
        def f():
            return g.normal(
                1.0, 2.0, sample_shape=g.Const(3)
            ) @ "x"

        vals = jnp.array([0.5, 1.5, 2.5])
        chm = g.C["x"].set(vals)
        score, ret = f.assess(chm, ())
        want = jnp.sum(jss.norm.logpdf(vals, 1.0, 2.0))
        assert jnp.allclose(score, want, atol=1e-6)
        tr, w = f.importance(jax.random.key(0), chm, ())
        assert jnp.allclose(w, want, atol=1e-6)


class TestTupledAddresses:
    """Parity: reference ``tests/core/generative/test_core.py``
    ``test_tupled_address`` (+ the conflict check the reference skips
    as unimplemented)."""

    def test_tupled_address_round_trip(self):
        @g.gen
        def f():
            x = g.normal(0.0, 1.0) @ ("x", "x0")
            y = g.normal(x, 1.0) @ "y"
            return y

        tr = f.simulate(jax.random.key(0), ())
        chm = tr.get_choices()
        x = chm["x", "x0"]
        proj = tr.project(
            jax.random.key(1), g.Selection.at["x", "x0"]
        )
        assert jnp.allclose(proj, jss.norm.logpdf(x, 0.0, 1.0))
        score, _ = f.assess(chm, ())
        assert jnp.allclose(score, tr.get_score(), atol=1e-6)
        new_tr, w, _, _ = tr.update(
            jax.random.key(2), g.C["x", "x0"].set(0.5)
        )
        assert float(new_tr.get_choices()["x", "x0"]) == 0.5
        assert jnp.allclose(
            w, new_tr.get_score() - tr.get_score(), atol=1e-6
        )

    def test_tupled_address_conflict(self):
        @g.gen
        def bad():
            a = g.normal(0.0, 1.0) @ ("x", "y")
            b = g.normal(0.0, 1.0) @ "x"
            return a + b

        with pytest.raises(g.AddressReuse):
            bad.simulate(jax.random.key(0), ())

    def test_singleton_tuple_is_plain_address(self):
        @g.gen
        def f():
            return g.normal(0.0, 1.0) @ ("x",)

        tr = f.simulate(jax.random.key(0), ())
        assert tr.get_choices()["x"] is not None


def test_iid_block_edit_paths():
    """Update / Regenerate on a sample_shape iid-block site."""
    from genjax_xla.gfi.requests import Regenerate
    from genjax_xla.gfi.selection import Selection

    @g.gen
    def f():
        return g.normal(0.0, 1.0, sample_shape=g.Const((3,))) @ "x"

    tr = f.simulate(jax.random.key(0), ())
    vals = jnp.array([0.1, 0.2, 0.3])
    new_tr, w, _, _ = tr.update(jax.random.key(1), g.C["x"].set(vals))
    assert jnp.allclose(new_tr.get_choices()["x"], vals)
    assert jnp.allclose(
        w, new_tr.get_score() - tr.get_score(), atol=1e-6
    )
    new_tr2, w2, _, _ = tr.edit(
        jax.random.key(2), Regenerate(Selection.at["x"])
    )
    assert new_tr2.get_choices()["x"].shape == (3,)
    assert float(w2) == 0.0
    assert not jnp.allclose(
        new_tr2.get_choices()["x"], tr.get_choices()["x"]
    )


class TestStructureChangingEdits:
    """Coarse-path Update/Regenerate across concrete control-flow
    changes that add or drop addresses (review findings: dropped sites
    previously kept their score in the weight; new sites crashed)."""

    def _model(self):
        @g.gen
        def m(n):
            x = g.normal(0.0, 1.0) @ "x"
            if n > 0:
                g.normal(x, 1.0) @ "extra"
            return x

        return m

    def test_dropped_site_weight_and_discard(self):
        from genjax_xla.core.compiler.interpreters.incremental import Diff

        m = self._model()
        tr = m.simulate(jax.random.key(0), (1,))
        new_tr, w, _, bwd = tr.edit(
            jax.random.key(1), g.Update(g.ChoiceMap.empty()),
            Diff.unknown_change((0,)),
        )
        assert jnp.allclose(
            w, new_tr.get_score() - tr.get_score(), atol=1e-6
        )
        assert bwd.constraint.has_value_at("extra")

    def test_new_site_unconstrained_and_constrained(self):
        from genjax_xla.core.compiler.interpreters.incremental import Diff

        m = self._model()
        tr0 = m.simulate(jax.random.key(0), (0,))
        _, w, _, _ = tr0.edit(
            jax.random.key(2), g.Update(g.ChoiceMap.empty()),
            Diff.unknown_change((1,)),
        )
        assert float(w) == 0.0
        new_tr, w3, _, _ = tr0.edit(
            jax.random.key(3), g.Update(g.C["extra"].set(0.7)),
            Diff.unknown_change((1,)),
        )
        x = new_tr.get_choices()["x"]
        assert jnp.allclose(w3, jss.norm.logpdf(0.7, x, 1.0), atol=1e-6)

    def test_regenerate_across_structure_change(self):
        from genjax_xla.core.compiler.interpreters.incremental import Diff
        from genjax_xla.gfi.requests import Regenerate
        from genjax_xla.gfi.selection import Selection

        m = self._model()
        tr = m.simulate(jax.random.key(0), (1,))
        new_tr, w, _, _ = tr.edit(
            jax.random.key(4), Regenerate(Selection.none()),
            Diff.unknown_change((0,)),
        )
        assert jnp.allclose(
            w, new_tr.get_score() - tr.get_score(), atol=1e-6
        )


class TestKwargsTraceStability:
    """handle_kwargs wrappers are cached per source: two traces of a
    model whose body passes kwargs to a traced @gen call share a
    treedef (MH accept/reject tree_maps over trace pairs)."""

    def test_tree_map_and_mh_over_kwarg_traces(self):
        import jax.tree_util as jtu
        from genjax_xla.inference import mh
        from genjax_xla.gfi.requests import Regenerate
        from genjax_xla.gfi.selection import Selection

        @g.gen
        def sub(mu, scale=1.0):
            return g.normal(mu, scale) @ "v"

        @g.gen
        def model():
            return sub(0.0, scale=2.0) @ "a"

        t1 = model.simulate(jax.random.key(0), ())
        t2 = model.simulate(jax.random.key(1), ())
        merged = jtu.tree_map(
            lambda a, b: jnp.where(True, a, b), t1, t2
        )
        assert float(merged.get_choices()["a", "v"]) == float(
            t1.get_choices()["a", "v"]
        )
        new_tr, _acc = mh(
            jax.random.key(2), t1, Regenerate(Selection.all())
        )
        assert jnp.isfinite(new_tr.get_score())

    def test_closure_passthroughs_resolve_kwargs(self):
        @g.gen
        def sub(mu, scale=1.0):
            return g.normal(mu, scale) @ "v"

        tr = sub(0.0, scale=2.0).simulate(jax.random.key(0))
        v = tr.get_choices()["v"] if "v" in tr.get_choices() else None
        # score must use scale=2.0, not the default 1.0
        chm = tr.get_choices()
        v = chm["v"]
        assert jnp.allclose(
            tr.get_score(), jss.norm.logpdf(v, 0.0, 2.0), atol=1e-6
        )
        # and a bare distribution closure with kwargs works too
        tr2 = g.normal(loc=1.0, scale=3.0).simulate(jax.random.key(1))
        assert jnp.allclose(
            tr2.get_score(),
            jss.norm.logpdf(tr2.get_retval(), 1.0, 3.0),
            atol=1e-6,
        )


def test_tupled_get_subtrace_descent():
    @g.gen
    def f():
        a = g.normal(0.0, 1.0) @ ("x", "x0")
        b = g.normal(0.0, 1.0) @ ("x", "x1")
        g.normal(0.0, 1.0) @ "y"
        return a + b

    tr = f.simulate(jax.random.key(0), ())
    assert jnp.allclose(
        tr.get_subtrace("x", "x0").get_score(),
        tr.get_subtrace(("x", "x0")).get_score(),
    )
    grp = tr.get_subtrace("x")
    assert jnp.allclose(
        grp.get_score(),
        tr.get_subtrace(("x", "x0")).get_score()
        + tr.get_subtrace(("x", "x1")).get_score(),
    )
