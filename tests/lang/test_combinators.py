"""Per-combinator GFI contract tests. Mirrors the reference's combinator
test files (``tests/generative_functions/test_{vmap,scan,switch,mask,dimap,
or_else,repeat,mix}_combinator.py`` — SURVEY §4.2): score/weight identities,
choice-map addressing, update weights.
"""

import jax
import jax.numpy as jnp
import jax.scipy.stats as jss
import numpy as np
import pytest

import genjax_xla as g

KEY = jax.random.key(314159)


@g.gen
def kernel(mu):
    x = g.normal(mu, 1.0) @ "x"
    return x


class TestVmap:
    def test_in_axes_validation(self):
        """Mapped args must agree on the axis length and the axis must
        exist (reference _static_broadcast_dim_length parity)."""
        import pytest

        @g.gen
        def two(a, b):
            return g.normal(a + b, 1.0) @ "x"

        vm = two.vmap(in_axes=(0, 0))
        with pytest.raises(ValueError, match="disagree"):
            vm.simulate(KEY, (jnp.zeros(4), jnp.zeros(5)))
        with pytest.raises(ValueError, match="out of bounds"):
            two.vmap(in_axes=(1, None)).simulate(
                KEY, (jnp.zeros(4), 0.0)
            )
        with pytest.raises(ValueError, match="entries for"):
            two.vmap(in_axes=(0,)).simulate(
                KEY, (jnp.zeros(4), jnp.zeros(4))
            )
        with pytest.raises(ValueError, match="axis_size=3"):
            two.vmap(in_axes=(0, 0), axis_size=3).simulate(
                KEY, (jnp.zeros(4), jnp.zeros(4))
            )
        # Consistent case still works.
        tr = vm.simulate(KEY, (jnp.zeros(4), jnp.ones(4)))
        assert tr.get_choices()[2, "x"] is not None

    def test_full_slice_reads_stacked_lanes(self):
        """``chm[:, "z"]`` exposes all lanes as one stacked array
        (canonical-lane Indexed nodes only)."""
        vm = kernel.vmap(in_axes=0)
        tr = vm.simulate(KEY, (jnp.arange(4.0),))
        chm = tr.get_choices()
        stacked = chm[:, "x"]
        assert stacked.shape == (4,)
        assert jnp.array_equal(stacked[2], chm[2, "x"])

    def test_simulate_score_is_sum(self):
        vm = kernel.vmap(in_axes=0)
        mus = jnp.arange(4.0)
        tr = vm.simulate(KEY, (mus,))
        chm = tr.get_choices()
        xs = jnp.stack([chm[i, "x"] for i in range(4)])
        want = jnp.sum(jss.norm.logpdf(xs, mus, 1.0))
        assert jnp.allclose(tr.get_score(), want)

    def test_assess_matches(self):
        vm = kernel.vmap(in_axes=0)
        mus = jnp.arange(4.0)
        tr = vm.simulate(KEY, (mus,))
        score, ret = vm.assess(tr.get_choices(), (mus,))
        assert jnp.allclose(score, tr.get_score())
        assert jnp.allclose(ret, tr.get_retval())

    def test_generate_partial_constraint(self):
        vm = kernel.vmap(in_axes=0)
        mus = jnp.zeros(4)
        constraint = g.C[2, "x"].set(1.5)
        tr, w = vm.generate(KEY, constraint, (mus,))
        assert jnp.allclose(tr.get_choices()[2, "x"], 1.5)
        assert jnp.allclose(w, jss.norm.logpdf(1.5, 0.0, 1.0))

    def test_update(self):
        vm = kernel.vmap(in_axes=0)
        mus = jnp.zeros(4)
        tr = vm.simulate(KEY, (mus,))
        new_tr, w, _, _ = tr.update(jax.random.key(1), g.C[1, "x"].set(0.0))
        assert jnp.allclose(new_tr.get_choices()[1, "x"], 0.0)
        assert jnp.allclose(
            w, new_tr.get_score() - tr.get_score(), atol=1e-5
        )

    def test_index_request(self):
        vm = kernel.vmap(in_axes=0)
        mus = jnp.zeros(4)
        tr = vm.simulate(KEY, (mus,))
        req = g.IndexRequest(1, g.Update(g.C["x"].set(2.0)))
        new_tr, w, _, bwd = tr.edit(jax.random.key(1), req)
        assert jnp.allclose(new_tr.get_choices()[1, "x"], 2.0)
        assert jnp.allclose(
            w, new_tr.get_score() - tr.get_score(), atol=1e-5
        )

    def test_vmap_sliced_choices(self):
        vm = kernel.vmap(in_axes=0)
        tr = vm.simulate(KEY, (jnp.zeros(8),))
        sub = tr.get_choices().get_submap(3)
        assert jnp.ndim(sub["x"]) == 0


@g.gen
def walk_step(carry, _):
    prev = carry
    x = g.normal(prev, 1.0) @ "x"
    return x, prev


class TestScan:
    def test_simulate_markov_score(self):
        sc = walk_step.scan(n=5)
        tr = sc.simulate(KEY, (0.0, None))
        chm = tr.get_choices()
        xs = jnp.stack([chm[i, "x"] for i in range(5)])
        prevs = jnp.concatenate([jnp.zeros(1), xs[:-1]])
        want = jnp.sum(jss.norm.logpdf(xs, prevs, 1.0))
        assert jnp.allclose(tr.get_score(), want, atol=1e-5)
        final, outs = tr.get_retval()
        assert jnp.allclose(final, xs[-1])

    def test_assess_matches(self):
        sc = walk_step.scan(n=5)
        tr = sc.simulate(KEY, (0.0, None))
        score, ret = sc.assess(tr.get_choices(), (0.0, None))
        assert jnp.allclose(score, tr.get_score(), atol=1e-5)

    def test_generate_with_observations(self):
        sc = walk_step.scan(n=3)
        constraint = g.C[1, "x"].set(0.5)
        tr, w = sc.generate(KEY, constraint, (0.0, None))
        chm = tr.get_choices()
        assert jnp.allclose(chm[1, "x"], 0.5)
        assert jnp.allclose(
            w, jss.norm.logpdf(0.5, chm[0, "x"], 1.0), atol=1e-6
        )

    def test_update_weight_identity(self):
        sc = walk_step.scan(n=4)
        tr = sc.simulate(KEY, (0.0, None))
        new_tr, w, _, _ = tr.update(jax.random.key(1), g.C[0, "x"].set(0.3))
        assert jnp.allclose(
            w, new_tr.get_score() - tr.get_score(), atol=1e-5
        )
        assert jnp.allclose(new_tr.get_choices()[0, "x"], 0.3)
        # retained downstream choices:
        assert jnp.allclose(
            new_tr.get_choices()[2, "x"], tr.get_choices()[2, "x"]
        )

    def test_scanned_inputs(self):
        @g.gen
        def step(carry, x):
            y = g.normal(carry + x, 1.0) @ "y"
            return y, y

        sc = step.scan()
        xs = jnp.arange(3.0)
        tr = sc.simulate(KEY, (0.0, xs))
        assert tr.get_retval()[1].shape == (3,)


class TestSwitch:
    def test_simulate_and_score(self):
        @g.gen
        def b0():
            return g.normal(0.0, 1.0) @ "x0"

        @g.gen
        def b1():
            return g.normal(10.0, 1.0) @ "x1"

        sw = g.switch(b0, b1)
        tr0 = sw.simulate(KEY, (0, (), ()))
        tr1 = sw.simulate(KEY, (1, (), ()))
        assert tr0.get_retval() < 5.0 < tr1.get_retval()
        assert jnp.allclose(
            tr0.get_score(),
            jss.norm.logpdf(tr0.get_choices()["x0"], 0.0, 1.0),
        )

    def test_traced_index(self):
        @g.gen
        def b0():
            return g.normal(0.0, 1.0) @ "x0"

        @g.gen
        def b1():
            return g.normal(10.0, 1.0) @ "x1"

        sw = g.switch(b0, b1)
        tr = jax.jit(sw.simulate)(KEY, (jnp.asarray(1), (), ()))
        v = tr.get_choices()["x1"]
        v = v.unmask() if isinstance(v, g.Mask) else v
        assert v > 5.0

    def test_assess_generate(self):
        @g.gen
        def b0():
            return g.flip(0.2) @ "h"

        @g.gen
        def b1():
            return g.flip(0.9) @ "h"

        sw = g.switch(b0, b1)
        score, _ = sw.assess(g.C["h"].set(True), (0, (), ()))
        assert jnp.allclose(score, jnp.log(0.2))
        score1, _ = sw.assess(g.C["h"].set(True), (jnp.asarray(1), (), ()))
        assert jnp.allclose(score1, jnp.log(0.9))
        tr, w = sw.generate(KEY, g.C["h"].set(True), (1, (), ()))
        assert jnp.allclose(w, jnp.log(0.9))

    def test_update(self):
        @g.gen
        def b0():
            return g.normal(0.0, 1.0) @ "x"

        @g.gen
        def b1():
            return g.normal(5.0, 2.0) @ "x"

        sw = g.switch(b0, b1)
        tr = sw.simulate(KEY, (0, (), ()))
        new_tr, w, _, _ = tr.update(jax.random.key(1), g.C["x"].set(0.7))
        assert jnp.allclose(
            w, new_tr.get_score() - tr.get_score(), atol=1e-5
        )


class TestMaskCombinator:
    def test_simulate_true_false(self):
        m = kernel.mask()
        tr_t = m.simulate(KEY, (True, 0.0))
        tr_f = m.simulate(KEY, (False, 0.0))
        assert jnp.allclose(
            tr_t.get_score(),
            jss.norm.logpdf(tr_t.get_retval().unmask(), 0.0, 1.0),
        )
        assert jnp.allclose(tr_f.get_score(), 0.0)

    def test_traced_flag(self):
        m = kernel.mask()
        tr = jax.jit(m.simulate)(KEY, (jnp.asarray(False), 0.0))
        assert jnp.allclose(tr.get_score(), 0.0)

    def test_edit_weight_table(self):
        m = kernel.mask()
        tr = m.simulate(KEY, (True, 0.0))
        inner_score = kernel.simulate(KEY, (0.0,)).get_score()
        # T -> F: weight = -inner score
        new_tr, w, _, _ = tr.update(
            jax.random.key(1),
            g.ChoiceMap.empty(),
            (g.Diff(False, g.UnknownChange), g.Diff(0.0, g.NoChange)),
        )
        assert jnp.allclose(w, -tr.get_score(), atol=1e-6)
        assert jnp.allclose(new_tr.get_score(), 0.0)
        # F -> T: weight = +new score
        tr_f = m.simulate(KEY, (False, 0.0))
        new_tr2, w2, _, _ = tr_f.update(
            jax.random.key(2),
            g.ChoiceMap.empty(),
            (g.Diff(True, g.UnknownChange), g.Diff(0.0, g.NoChange)),
        )
        assert jnp.allclose(w2, new_tr2.get_score(), atol=1e-6)


class TestDimap:
    def test_dimap_roundtrip(self):
        d = kernel.dimap(
            pre=lambda a, b: (a + b,), post=lambda args, r: r * 2.0
        )
        tr = d.simulate(KEY, (1.0, 2.0))
        inner = kernel.simulate(KEY, (3.0,))
        assert jnp.allclose(tr.get_retval(), inner.get_retval() * 2.0)
        assert jnp.allclose(tr.get_score(), inner.get_score())

    def test_map_contramap(self):
        mp = kernel.map(lambda r: r + 100.0)
        tr = mp.simulate(KEY, (0.0,))
        assert tr.get_retval() > 50.0
        cm = kernel.contramap(lambda a: (a * 0.0,))
        tr2 = cm.simulate(KEY, (123.0,))
        assert jnp.abs(tr2.get_retval()) < 10.0

    def test_dimap_update_weight(self):
        d = kernel.dimap(pre=lambda a: (a * 2.0,))
        tr = d.simulate(KEY, (0.5,))
        new_tr, w, _, _ = tr.update(jax.random.key(1), g.C["x"].set(0.0))
        assert jnp.allclose(
            w, new_tr.get_score() - tr.get_score(), atol=1e-6
        )


class TestOrElse:
    def test_or_else(self):
        @g.gen
        def if_fn():
            return g.normal(0.0, 1.0) @ "a"

        @g.gen
        def else_fn():
            return g.normal(100.0, 1.0) @ "b"

        oe = if_fn.or_else(else_fn)
        tr_t = oe.simulate(KEY, (True, (), ()))
        tr_f = oe.simulate(KEY, (False, (), ()))
        assert tr_t.get_retval() < 50.0 < tr_f.get_retval()


class TestRepeat:
    def test_repeat(self):
        r = kernel.repeat(n=6)
        tr = r.simulate(KEY, (0.0,))
        chm = tr.get_choices()
        xs = jnp.stack([chm[i, "x"] for i in range(6)])
        assert len(np.unique(np.asarray(xs))) == 6
        want = jnp.sum(jss.norm.logpdf(xs, 0.0, 1.0))
        assert jnp.allclose(tr.get_score(), want, atol=1e-5)


class TestMix:
    def test_mix_scores(self):
        @g.gen
        def c0():
            return g.normal(-5.0, 1.0) @ "x"

        @g.gen
        def c1():
            return g.normal(5.0, 1.0) @ "x"

        m = g.mix(c0, c1)
        logits = jnp.log(jnp.array([0.5, 0.5]))
        tr = m.simulate(KEY, (logits, (), ()))
        comp = tr.get_choices()["mixture_component"]
        v = tr.get_choices()["mixture_branch", "x"]
        if isinstance(v, g.Mask):
            v = v.unmask()
        mu = jnp.where(comp == 0, -5.0, 5.0)
        want = jnp.log(0.5) + jss.norm.logpdf(v, mu, 1.0)
        assert jnp.allclose(tr.get_score(), want, atol=1e-5)


class TestIterateAccumulate:
    def test_iterate(self):
        @g.gen
        def double_step(x):
            return g.normal(x * 2.0, 1e-6) @ "x"

        it = double_step.iterate(n=3)
        tr = it.simulate(KEY, (1.0,))
        ret = tr.get_retval()
        assert ret.shape == (4,)
        np.testing.assert_allclose(
            np.asarray(ret), [1.0, 2.0, 4.0, 8.0], atol=1e-3
        )

    def test_iterate_final(self):
        @g.gen
        def inc(x):
            return g.normal(x + 1.0, 1e-6) @ "x"

        itf = inc.iterate_final(n=5)
        tr = itf.simulate(KEY, (0.0,))
        assert jnp.allclose(tr.get_retval(), 5.0, atol=1e-3)

    def test_accumulate(self):
        @g.gen
        def add(acc, x):
            return g.normal(acc + x, 1e-6) @ "s"

        acc = add.accumulate()
        xs = jnp.ones(4)
        tr = acc.simulate(KEY, (0.0, xs))
        np.testing.assert_allclose(
            np.asarray(tr.get_retval()), [0, 1, 2, 3, 4], atol=1e-3
        )

    def test_reduce(self):
        @g.gen
        def add(acc, x):
            return g.normal(acc + x, 1e-6) @ "s"

        red = add.reduce()
        tr = red.simulate(KEY, (0.0, jnp.arange(4.0)))
        assert jnp.allclose(tr.get_retval(), 6.0, atol=1e-3)

    def test_masked_iterate_final(self):
        @g.gen
        def inc(x):
            return g.normal(x + 1.0, 1e-6) @ "x"

        mit = inc.masked_iterate_final()
        flags = jnp.array([True, False, True, True, False])
        tr = mit.simulate(KEY, (0.0, flags))
        assert jnp.allclose(tr.get_retval(), 3.0, atol=1e-3)

    def test_masked_iterate(self):
        @g.gen
        def inc(x):
            return g.normal(x + 1.0, 1e-6) @ "x"

        mit = inc.masked_iterate()
        flags = jnp.array([True, False, True])
        tr = mit.simulate(KEY, (0.0, flags))
        np.testing.assert_allclose(
            np.asarray(tr.get_retval()), [0, 1, 1, 2], atol=1e-3
        )


class TestSwitchIndexChange:
    def test_index_change_edit(self):
        @g.gen
        def b0():
            return g.normal(0.0, 1.0) @ "x"

        @g.gen
        def b1():
            return g.normal(10.0, 2.0) @ "y"

        sw = g.switch(b0, b1)
        tr = sw.simulate(KEY, (0, (), ()))
        argdiffs = (
            g.Diff(1, g.UnknownChange),
            g.Diff((), g.NoChange),
            g.Diff((), g.NoChange),
        )
        new_tr, w, _rd, bwd = sw.edit(
            jax.random.key(1), tr, g.Update(g.ChoiceMap.empty()), argdiffs
        )
        # Now on branch 1:
        y = new_tr.get_choices()["y"]
        y = y.unmask() if isinstance(y, g.Mask) else y
        assert y > 3.0
        # weight = fresh-prior proposal: s_new - s_old + 0 edit weight...
        assert jnp.allclose(
            w, new_tr.get_score() - tr.get_score(), atol=1e-5
        )
        # Backward: replay the old choices to return to branch 0.
        back_diffs = (
            g.Diff(0, g.UnknownChange),
            g.Diff((), g.NoChange),
            g.Diff((), g.NoChange),
        )
        back_tr, w_b, _, _ = sw.edit(
            jax.random.key(2), new_tr, bwd, back_diffs
        )
        assert jnp.allclose(back_tr.get_score(), tr.get_score(), atol=1e-5)

    def test_index_change_with_constraint(self):
        @g.gen
        def b0():
            return g.flip(0.2) @ "h0"

        @g.gen
        def b1():
            return g.flip(0.9) @ "h1"

        sw = g.switch(b0, b1)
        tr = sw.simulate(KEY, (0, (), ()))
        argdiffs = (
            g.Diff(1, g.UnknownChange),
            g.Diff((), g.NoChange),
            g.Diff((), g.NoChange),
        )
        new_tr, w, _, _ = sw.edit(
            jax.random.key(1), tr, g.Update(g.C["h1"].set(True)), argdiffs
        )
        v = new_tr.get_choices()["h1"]
        v = v.unmask() if isinstance(v, g.Mask) else v
        assert bool(v) is True
        assert jnp.allclose(new_tr.get_score(), jnp.log(0.9), atol=1e-6)


class TestScanIndexRequest:
    def test_single_step_repair(self):
        """Observation-style model: the carry never depends on the edited
        choice, so the O(1) repair applies."""

        @g.gen
        def step(carry, _):
            x = g.normal(carry, 0.5) @ "x"
            _ = g.normal(x, 0.3) @ "y"
            return carry + 1.0, x

        sc = step.scan(n=5)
        tr = sc.simulate(KEY, (0.0, None))
        req = g.IndexRequest(2, g.Update(g.C["y"].set(0.9)))
        new_tr, w, _, bwd = tr.edit(jax.random.key(1), req)
        assert jnp.allclose(new_tr.get_choices()[2, "y"], 0.9)
        # other steps untouched:
        assert jnp.allclose(
            new_tr.get_choices()[3, "y"], tr.get_choices()[3, "y"]
        )
        assert jnp.allclose(
            w, new_tr.get_score() - tr.get_score(), atol=1e-5
        )
        # backward inverts:
        back_tr, w_b, _, _ = new_tr.edit(jax.random.key(2), bwd)
        assert jnp.allclose(w + w_b, 0.0, atol=1e-5)

    def test_repair_at_last_step(self):
        @g.gen
        def step(carry, _):
            x = g.normal(carry, 0.5) @ "x"
            return carry * 1.0, x

        sc = step.scan(n=3)
        tr = sc.simulate(KEY, (1.0, None))
        req = g.IndexRequest(2, g.Update(g.C["x"].set(0.0)))
        new_tr, w, _, _ = tr.edit(jax.random.key(1), req)
        assert jnp.allclose(new_tr.get_choices()[2, "x"], 0.0)
        assert jnp.allclose(
            w, new_tr.get_score() - tr.get_score(), atol=1e-5
        )

    def test_carry_dependent_repair_propagates_one_step(self):
        """Markov model where x feeds the carry: step t+1 is rescored."""

        @g.gen
        def step(carry, _):
            x = g.normal(carry, 1.0) @ "x"
            return x, x

        sc = step.scan(n=4)
        tr = sc.simulate(KEY, (0.0, None))
        req = g.IndexRequest(1, g.Update(g.C["x"].set(0.5)))
        new_tr, w, _, _ = tr.edit(jax.random.key(1), req)
        assert jnp.allclose(new_tr.get_choices()[1, "x"], 0.5)
        # weight accounts for step 1 (constrained) and step 2 (rescored):
        import jax.scipy.stats as jss

        c = tr.get_choices()
        want = (
            jss.norm.logpdf(0.5, c[0, "x"], 1.0)
            - jss.norm.logpdf(c[1, "x"], c[0, "x"], 1.0)
            + jss.norm.logpdf(c[2, "x"], 0.5, 1.0)
            - jss.norm.logpdf(c[2, "x"], c[1, "x"], 1.0)
        )
        assert jnp.allclose(w, want, atol=1e-5)


class TestSwitchIndexChangeRegenerate:
    def test_regenerate_across_index_change(self):
        @g.gen
        def b0():
            return g.normal(0.0, 1.0) @ "x"

        @g.gen
        def b1():
            return g.normal(8.0, 1.0) @ "y"

        sw = g.switch(b0, b1)
        tr = sw.simulate(KEY, (0, (), ()))
        argdiffs = (
            g.Diff(1, g.UnknownChange),
            g.Diff((), g.NoChange),
            g.Diff((), g.NoChange),
        )
        new_tr, w, _, bwd = sw.edit(
            jax.random.key(1), tr, g.Regenerate(g.S.all()), argdiffs
        )
        y = new_tr.get_choices()["y"]
        y = y.unmask() if isinstance(y, g.Mask) else y
        assert y > 4.0
        # Round 5: the switch subtree contributes ZERO — the fresh
        # branch's density is the forward proposal density and the old
        # branch's the backward one, cancelling exactly (the previous
        # Dscore weight made mh() greedy toward higher-density
        # branches; +0.10 measured posterior bias). Downstream
        # likelihood deltas come from the enclosing handler.
        assert jnp.allclose(w, 0.0, atol=1e-6)
        # bwd is the self-inverse Regenerate: replaying it lands back
        # on branch 0 with FRESH values (a kernel, not a restore).
        assert isinstance(bwd, g.Regenerate)
        back_diffs = (
            g.Diff(0, g.UnknownChange),
            g.Diff((), g.NoChange),
            g.Diff((), g.NoChange),
        )
        back_tr, w_b, _, _ = sw.edit(jax.random.key(2), new_tr, bwd,
                                     back_diffs)
        assert jnp.allclose(w_b, 0.0, atol=1e-6)
        x_back = back_tr.get_choices()["x"]
        x_back = (x_back.unmask()
                  if isinstance(x_back, g.Mask) else x_back)
        assert abs(float(x_back)) < 5.0  # branch 0 again

    def test_traced_index_inner_trace(self):
        @g.gen
        def b0():
            return g.normal(0.0, 1.0) @ "x"

        @g.gen
        def b1():
            return g.normal(10.0, 1.0) @ "x"

        sw = g.switch(b0, b1)
        tr = jax.jit(sw.simulate)(KEY, (jnp.asarray(1), (), ()))
        sub = tr.get_inner_trace("x")
        assert float(sub.get_retval()) > 5.0


class TestScanEdgeCases:
    """Parity: reference ``test_scan_combinator.py`` GEN-333
    (zero-length) and length inference."""

    def test_zero_length_scan(self):
        @g.gen
        def step(state, sigma):
            new_x = g.normal(state, sigma) @ "x"
            return new_x, new_x + 1

        tr = step.scan(n=0).simulate(
            KEY, (2.0, jnp.arange(0, dtype=float))
        )
        assert tr.get_choices().static_is_empty()
        assert float(tr.get_score()) == 0.0
        # importance against the empty choices round-trips
        _tr2, w = step.scan().importance(
            jax.random.key(1), tr.get_choices(),
            (2.0, jnp.arange(0, dtype=float)),
        )
        assert float(w) == 0.0

    def test_scan_length_inferred(self):
        @g.gen
        def step(c, x):
            z = g.normal(c + x, 1.0) @ "z"
            return z, z

        tr = step.scan().simulate(KEY, (0.0, jnp.arange(3.0)))
        assert tr.get_retval()[1].shape == (3,)
        assert tr.get_choices()[:, "z"].shape == (3,)


def test_mask_fails_with_vector_mask():
    """Parity: reference ``test_mask_fails_with_vector_mask`` — a
    vector flag would yield a vector score (GFI contract violation);
    vmap under traced scalar flags still works."""
    @g.gen
    def model():
        return g.normal(0.0, 1.0) @ "x"

    with pytest.raises(TypeError, match="scalar"):
        model.mask().simulate(KEY, (jnp.array([True, True, False]),))

    # vmap over the flag axis is the supported spelling:
    trs = jax.vmap(
        lambda k, f: model.mask().simulate(k, (f,)).get_score()
    )(jax.random.split(KEY, 3), jnp.array([True, True, False]))
    assert trs.shape == (3,)
    assert float(trs[2]) == 0.0


class TestVmapArrayConstraints:
    """Vmap-level constraints as bare array choices (parity: reference
    ``Choice.get_inner_map`` dynamic indexing; GEN-903
    ``test_assess_vmap_masked``)."""

    def test_plain_choice_array_constrains_all_lanes(self):
        gf = g.flip.vmap(in_axes=(0,))
        fp = jnp.array([0.2, 0.4, 0.6])
        want = jnp.array([1, 1, 1], dtype=bool)
        chm = g.ChoiceMap.choice(want)
        tr, w = gf.importance(KEY, chm, (fp,))
        assert jnp.array_equal(tr.get_retval(), want)
        exact = jnp.sum(jnp.log(fp))
        assert jnp.allclose(w, exact, atol=1e-6)

    def test_assess_vmap_masked_switch_chm(self):
        gf = g.flip.vmap(in_axes=(0,))
        fp = jnp.array([0.2, 0.4, 0.6])

        @jax.jit
        def get_choicemap(idx):
            return g.ChoiceMap.switch(idx, [
                g.ChoiceMap.choice(jnp.array([0, 0, 1], dtype=bool)),
                g.ChoiceMap.choice(jnp.array([1, 1, 1], dtype=bool)),
            ])

        chm = get_choicemap(1)
        tr, w = gf.importance(jax.random.key(0), chm, (fp,))
        score, r = gf.assess(chm, (fp,))
        assert jnp.array_equal(tr.get_retval(), r)
        assert jnp.allclose(tr.get_score(), score)
        assert jnp.allclose(score, w), "no weight change w/ same chm"


class TestGetSubtrace:
    """Parity: reference ``tests/core/generative/test_core.py``
    ``test_get_subtrace_{switch,vmap,scan}``."""

    def test_get_subtrace_switch(self):
        @g.gen
        def f():
            return g.normal(0.0, 0.01) @ "x"

        @g.gen
        def g2():
            return g.uniform(10.0, 11.0) @ "y"

        @g.gen
        def h():
            flip = g.flip(0.5) @ "flip"
            return f.or_else(g2)(flip, (), ()) @ "z"

        tr = h.simulate(KEY, ())
        flip_tr = tr.get_subtrace("flip")
        if bool(flip_tr.get_retval()):
            live = tr.get_subtrace("z", "x")
        else:
            live = tr.get_subtrace("z", "y")
        assert jnp.allclose(
            live.get_score(), tr.get_score() - flip_tr.get_score(),
            atol=1e-6,
        )

    def test_get_subtrace_vmap(self):
        vm = kernel.vmap(in_axes=0)
        tr = vm.simulate(KEY, (jnp.arange(5.0),))
        st = tr.get_subtrace("x")
        assert st.get_score().shape == (5,)
        assert jnp.allclose(jnp.sum(st.get_score()), tr.get_score())

    def test_get_subtrace_scan(self):
        sc = walk_step.scan(n=4)
        tr = sc.simulate(KEY, (0.0, None))
        st = tr.get_subtrace("x")
        assert st.get_score().shape == (4,)
        assert jnp.allclose(
            jnp.sum(st.get_score()), tr.get_score(), atol=1e-6
        )


def test_vmap_axis_name_collectives():
    """axis_name threads into the lane vmaps: collectives inside the
    model body resolve the named axis (previously silently dropped)."""
    @g.gen
    def m(mu):
        x = g.normal(mu, 1.0) @ "x"
        return x - jax.lax.pmean(x, axis_name="lanes")

    vm = m.vmap(in_axes=0, axis_name="lanes")
    tr = vm.simulate(KEY, (jnp.arange(4.0),))
    assert jnp.allclose(jnp.mean(tr.get_retval()), 0.0, atol=1e-6)
    score, _ = vm.assess(tr.get_choices(), (jnp.arange(4.0),))
    assert jnp.allclose(score, tr.get_score(), atol=1e-6)


class TestScanIndexRequestRegressions:
    """Late round-2 self-review fixes."""

    def test_index_request_with_changed_args_consistent(self):
        """Changed args lower the O(1) repair to a whole-chain Update:
        the result must satisfy score == assess(choices, new args)."""
        from genjax_xla.core.compiler.interpreters.incremental import Diff

        @g.gen
        def step(c, x):
            z = g.normal(c + x, 1.0) @ "z"
            return z, z

        sc = step.scan(n=4)
        tr = sc.simulate(KEY, (0.0, jnp.zeros(4)))
        xs_new = jnp.full(4, 5.0)
        req = g.IndexRequest(1, g.Update(g.C["z"].set(0.3)))
        new_tr, w, _, _ = sc.edit(
            jax.random.key(1), tr, req,
            (Diff.no_change(0.0), Diff.unknown_change(xs_new)),
        )
        score, _ = sc.assess(new_tr.get_choices(), new_tr.get_args())
        assert jnp.allclose(score, new_tr.get_score(), atol=1e-5)
        assert jnp.allclose(
            w, new_tr.get_score() - tr.get_score(), atol=1e-5
        )

    def test_carry_check_staged_and_gated(self):
        """The opt-in carry assertion stages under checkify (no Python
        bool conversion), passes at idx = n-2 (no downstream step),
        and flags a genuinely-propagating mid-chain edit."""
        from jax.experimental import checkify

        from genjax_xla.core.checks import do_checkify
        from genjax_xla.core.compiler.interpreters.incremental import Diff

        @g.gen
        def acc_step(c, _):
            z = g.normal(0.0, 1.0) @ "z"
            return c + z, c

        sc = acc_step.scan(n=5)
        tr = sc.simulate(KEY, (0.0, None))

        def run(req):
            with do_checkify():
                err, _ = checkify.checkify(
                    lambda: sc.edit(
                        jax.random.key(1), tr, req,
                        Diff.no_change((0.0, None)),
                    )
                )()
            return err.get()

        assert run(g.IndexRequest(3, g.Update(g.C["z"].set(0.2)))) is None
        assert run(
            g.IndexRequest(1, g.Update(g.C["z"].set(9.0)))
        ) is not None


class TestScanIndexRequestGenericSubrequest:
    """Round 3 (VERDICT r2 weak #6): IndexRequest with CHANGED args and
    a sub-request beyond Update/Regenerate — lowered to an arg-rescore
    phase + the O(1) index repair."""

    def _model(self):
        @g.gen
        def step(c, x):
            z = g.normal(c * 0.5 + x, 1.0) @ "z"
            _ = g.normal(z, 0.3) @ "y"
            return c, z

        return step.scan(n=4)

    def test_hmc_subrequest_with_changed_args(self):
        from genjax_xla.core.compiler.interpreters.incremental import Diff
        from genjax_xla.inference.requests.hmc import HMC

        sc = self._model()
        xs = jnp.zeros(4)
        tr = sc.simulate(KEY, (0.0, xs))
        xs_new = jnp.full(4, 1.5)
        req = g.IndexRequest(1, HMC(g.S.at["z"], 0.05, 5))
        new_tr, w, _, bwd = sc.edit(
            jax.random.key(1), tr, req,
            (Diff.no_change(0.0), Diff.unknown_change(xs_new)),
        )
        # Score consistency under the NEW args.
        score, _ = sc.assess(new_tr.get_choices(), new_tr.get_args())
        assert jnp.allclose(score, new_tr.get_score(), atol=1e-5)
        # Only step 1's z moved; other steps' choices unchanged.
        for t in (0, 2, 3):
            assert jnp.allclose(
                new_tr.get_choices()[t, "z"], tr.get_choices()[t, "z"]
            )
        assert bool(jnp.isfinite(w))
        # Backward is an IndexRequest again (round-trips through the
        # same lowering at the reversed argdiffs without raising).
        assert isinstance(bwd, g.IndexRequest)
        back_tr, w_b, _, _ = sc.edit(
            jax.random.key(2), new_tr, bwd,
            (Diff.no_change(0.0), Diff.unknown_change(xs)),
        )
        score_b, _ = sc.assess(back_tr.get_choices(), back_tr.get_args())
        assert jnp.allclose(score_b, back_tr.get_score(), atol=1e-5)

    def test_rejuvenate_subrequest_with_changed_args(self):
        from genjax_xla.core.compiler.interpreters.incremental import Diff
        from genjax_xla.inference.requests.rejuvenate import Rejuvenate

        @g.gen
        def prop(old):
            _ = g.normal(old["z"], 0.1) @ "z"

        sc = self._model()
        xs = jnp.zeros(4)
        tr = sc.simulate(KEY, (0.0, xs))
        req = g.IndexRequest(2, Rejuvenate(prop))
        new_tr, w, _, _ = sc.edit(
            jax.random.key(3), tr, req,
            (Diff.no_change(0.0), Diff.unknown_change(jnp.ones(4))),
        )
        score, _ = sc.assess(new_tr.get_choices(), new_tr.get_args())
        assert jnp.allclose(score, new_tr.get_score(), atol=1e-5)
        assert bool(jnp.isfinite(w))


class TestSwitchIndexMHPosterior:
    def test_mh_over_traced_index_matches_quadrature(self):
        """Round-5 property-audit find: MH regenerating a traced switch
        index (cross-branch moves) must target the exact posterior —
        the pre-fix Δscore alpha measured +0.10 bias toward the
        higher-density branch on this conjugate model."""
        import numpy as np

        from genjax_xla.inference import Target, mh

        @g.gen
        def b0():
            return g.normal(0.0, 1.0) @ "v"

        @g.gen
        def b1():
            return g.normal(2.0, 1.0) @ "v"

        @g.gen
        def model():
            idx = g.categorical(
                jnp.log(jnp.array([0.5, 0.5]))
            ) @ "idx"
            out = b0.switch(b1)(idx, (), ()) @ "sw"
            _ = g.normal(out, 0.5) @ "y"

        y_obs = 1.5
        target = Target(model, (), g.C["y"].set(y_obs))
        # Exact: P(idx=k | y) ∝ 0.5 · N(y; mu_k, sqrt(1 + 0.25)).
        import scipy.stats as st

        lik = [st.norm.pdf(y_obs, mk, np.sqrt(1.25)) for mk in (0.0, 2.0)]
        p1_exact = lik[1] / (lik[0] + lik[1])

        tr, _ = target.importance(
            jax.random.key(0), g.ChoiceMap.empty()
        )
        req = g.Regenerate(
            g.Selection.at["idx"] | g.Selection.at["sw"]
        )

        def step(tr, k):
            new_tr, _ = mh(k, tr, req)
            return new_tr, new_tr.get_choices()["idx"]

        _, idxs = jax.lax.scan(
            step, tr, jax.random.split(jax.random.key(1), 8000)
        )
        p1 = float((np.asarray(idxs)[2000:] == 1).mean())
        assert abs(p1 - p1_exact) < 0.035, (p1, p1_exact)


class TestInlineCombinatorSugar:
    def test_inline_mix_mh_matches_quadrature(self):
        """Round-5 fuzz find: combinator sugar built INLINE in a @gen
        body (``c0.mix(c1)(...) @ "m"``) used to mint a fresh closure
        per trace, so accept/reject tree_maps and scan carries failed
        on structural inequality; the construction is now cached per
        component tuple. End-to-end: MH over the mixture component
        matches the exact two-component posterior."""
        import numpy as np
        import scipy.stats as st

        from genjax_xla.inference import Target, mh

        @g.gen
        def c0(shift):
            return g.normal(shift, 1.0) @ "v"

        @g.gen
        def c1(shift):
            return g.normal(-shift, 2.0) @ "v"

        @g.gen
        def model():
            out = c0.mix(c1)(
                jnp.log(jnp.array([0.3, 0.7])), (2.0,), (2.0,)
            ) @ "m"
            _ = g.normal(out, 0.5) @ "y"

        y = 1.0
        target = Target(model, (), g.C["y"].set(y))
        lik0 = 0.3 * st.norm.pdf(y, 2.0, np.sqrt(1.25))
        lik1 = 0.7 * st.norm.pdf(y, -2.0, np.sqrt(4.25))
        p1_exact = lik1 / (lik0 + lik1)
        tr, _ = target.importance(
            jax.random.key(0), g.ChoiceMap.empty()
        )
        req = g.Regenerate(g.Selection.at["m"])

        def step(tr, k):
            new_tr, _ = mh(k, tr, req)
            return new_tr, new_tr.get_choices()[
                "m", "mixture_component"
            ]

        _, idxs = jax.lax.scan(
            step, tr, jax.random.split(jax.random.key(1), 8000)
        )
        p1 = float((np.asarray(idxs)[2000:] == 1).mean())
        assert abs(p1 - p1_exact) < 0.04, (p1, p1_exact)

    def test_mix_and_or_else_construction_cached(self):
        @g.gen
        def a(s):
            return g.normal(s, 1.0) @ "x"

        @g.gen
        def b(s):
            return g.gamma(2.0, 2.0) @ "x"

        assert a.mix(b) is a.mix(b)
        assert a.or_else(b) is a.or_else(b)
