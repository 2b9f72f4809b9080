"""Randomized GFI contract properties across COMPOSED model structures.

The per-combinator suites pin each identity on hand-written models;
this file sweeps the same identities over a random zoo of composed
structures (nested @gen, scan-wrapped, vmap-wrapped, switch-wrapped,
mixed discrete/continuous sites) so structural edge interactions get
coverage no hand-written case enumerates:

1. assess(get_choices()) score == simulate score (trace/assess
   agreement);
2. generate under FULL constraints: weight == score (importance with
   nothing left to propose);
3. project(all) == score;
4. Update round trip to the same choices: weight == 0;
5. Regenerate prior-proposal identity: the edit weight equals the
   score delta minus the selected sites' own density delta (the
   downstream-likelihood change — the MH alpha for a prior-proposal
   move), and an Update restoring the ORIGINAL selected values lands
   exactly back on the original trace with weight = -(score delta)
   (reference generative_function.py:558-603 move semantics).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import genjax_xla as g
from genjax_xla.gfi.requests import Regenerate, Update
from genjax_xla.gfi.selection import Selection


def _make_model(structure: str, mu: float):
    @g.gen
    def leaf(shift):
        a = g.normal(shift, 1.0) @ "a"
        b = g.flip(0.3) @ "b"
        c = g.gamma(2.0, 2.0) @ "c"
        return a + jnp.where(b, 1.0, 0.0) + c

    if structure == "nested":
        @g.gen
        def model(shift):
            x = leaf(shift) @ "inner"
            y = g.normal(x, 0.5) @ "y"
            return y

        return model, (mu,)
    if structure == "scan":
        @g.gen
        def step(carry, x):
            z = g.normal(carry * 0.5, 1.0) @ "z"
            return z, z

        model = step.scan(n=4)
        return model, (mu, jnp.zeros(4))
    if structure == "vmap":
        model = leaf.vmap(in_axes=(0,))
        return model, (mu + jnp.arange(3.0),)
    if structure == "mask":
        model = leaf.mask()
        return model, (mu > 0.0, mu)  # flag flips with the drawn mu
    if structure == "or_else":
        @g.gen
        def other(shift):
            return g.gamma(2.0, 2.0) @ "c2"

        model = leaf.or_else(other)
        return model, (mu > 0.0, (mu,), (mu,))
    if structure == "mix":
        @g.gen
        def c0(shift):
            return g.normal(shift, 1.0) @ "v"

        @g.gen
        def c1(shift):
            return g.normal(-shift, 2.0) @ "v"

        model = c0.mix(c1)
        return model, (jnp.log(jnp.array([0.3, 0.7])), (mu,), (mu,))
    if structure == "switch":
        @g.gen
        def br0(shift):
            return g.normal(shift, 1.0) @ "v"

        @g.gen
        def br1(shift):
            return g.gamma(2.0, 2.0) @ "v"

        @g.gen
        def model(shift):
            idx = g.categorical(jnp.log(jnp.array([0.5, 0.5]))) @ "idx"
            out = br0.switch(br1)(idx, (shift,), (shift,)) @ "sw"
            return out

        return model, (mu,)
    raise ValueError(structure)


STRUCTURES = ["nested", "scan", "vmap", "switch", "mask", "or_else", "mix"]


class TestRandomizedContracts:
    @given(
        st.sampled_from(STRUCTURES),
        st.integers(0, 2**16),
        st.floats(-2.0, 2.0),
    )
    @settings(max_examples=16, deadline=None)
    def test_simulate_assess_generate_project(self, structure, seed, mu):
        model, args = _make_model(structure, mu)
        key = jax.random.key(seed)
        tr = model.simulate(key, args)
        score = float(tr.get_score())
        chm = tr.get_choices()

        # 1. assess agreement.
        assess_score, _ret = model.assess(chm, args)
        np.testing.assert_allclose(float(assess_score), score,
                                   rtol=1e-5, atol=1e-6)

        # 2. generate under full constraints: weight == score.
        tr2, w = model.generate(jax.random.fold_in(key, 1), chm, args)
        np.testing.assert_allclose(float(w), score, rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(float(tr2.get_score()), score,
                                   rtol=1e-5, atol=1e-6)

        # 3. project(all) == score.
        proj = tr.project(jax.random.fold_in(key, 2), Selection.all())
        np.testing.assert_allclose(float(proj), score, rtol=1e-5,
                                   atol=1e-6)

    @given(
        st.sampled_from(STRUCTURES),
        st.integers(0, 2**16),
    )
    @settings(max_examples=12, deadline=None)
    def test_update_same_choices_weight_zero(self, structure, seed):
        model, args = _make_model(structure, 0.5)
        key = jax.random.key(seed)
        tr = model.simulate(key, args)
        new_tr, w, _rd, _bwd = tr.edit(
            jax.random.fold_in(key, 1), Update(tr.get_choices())
        )
        np.testing.assert_allclose(float(w), 0.0, atol=1e-5)
        np.testing.assert_allclose(
            float(new_tr.get_score()), float(tr.get_score()), rtol=1e-6
        )

    @given(
        st.sampled_from(["nested", "scan", "vmap"]),
        st.integers(0, 2**16),
    )
    @settings(max_examples=12, deadline=None)
    def test_regenerate_weight_and_update_restore(self, structure, seed):
        model, args = _make_model(structure, 0.5)
        key = jax.random.key(seed)
        tr = model.simulate(key, args)
        sel = {
            "nested": Selection.at["inner", "a"],
            "scan": Selection.at[1, "z"],
            "vmap": Selection.at[0, "a"],
        }[structure]
        mid, w_fwd, _rd, _bwd = tr.edit(
            jax.random.fold_in(key, 1), Regenerate(sel)
        )
        # Prior-proposal identity: w = dScore - dProject(sel) — the
        # regenerated sites' own densities cancel against the proposal,
        # leaving the downstream-likelihood change (the MH alpha).
        d_score = float(mid.get_score()) - float(tr.get_score())
        pk = jax.random.fold_in(key, 9)
        d_self = float(mid.project(pk, sel)) - float(tr.project(pk, sel))
        np.testing.assert_allclose(
            float(w_fwd), d_score - d_self, rtol=1e-5, atol=1e-5
        )
        # Deterministic restore: Update with the ORIGINAL values of the
        # selected sites returns to the original trace exactly, with
        # weight = -(score delta).
        restore = tr.get_choices().filter(sel)
        back, w_back, _rd2, _b2 = mid.edit(
            jax.random.fold_in(key, 2), Update(restore)
        )
        np.testing.assert_allclose(
            float(back.get_score()), float(tr.get_score()), rtol=1e-5
        )
        np.testing.assert_allclose(
            float(w_back), -d_score, rtol=1e-5, atol=1e-5
        )


class TestMaskedOffAssess:
    def test_simulate_assess_roundtrip_static_false(self):
        """Round-5 combinator-fuzz fix: a statically masked-OFF trace's
        choices prune to Empty, and assess must return score 0 with a
        masked retval instead of raising MissingAddress."""
        @g.gen
        def inner(shift):
            a = g.normal(shift, 1.0) @ "a"
            return a

        model = inner.mask()
        tr = model.simulate(jax.random.key(0), (False, 0.5))
        assert float(tr.get_score()) == 0.0
        score, retval = model.assess(tr.get_choices(), (False, 0.5))
        assert float(score) == 0.0
        assert not bool(retval.flag)
        # generate under the same (empty) choices agrees.
        _tr2, w = model.generate(
            jax.random.key(1), tr.get_choices(), (False, 0.5)
        )
        assert float(w) == 0.0


class TestNestedCompositionContracts:
    """Deterministic sweep of the core identities over NESTED
    combinator compositions (scan-of-switch exercises the traced-index
    switch path inside a scan; vmap-of-mask the per-lane flag path)."""

    def _make(self, structure):
        if structure == "scan_of_switch":
            @g.gen
            def b0(shift):
                return g.normal(shift, 1.0) @ "v"

            @g.gen
            def b1(shift):
                return g.normal(-shift, 2.0) @ "v"

            @g.gen
            def step(carry, x):
                idx = g.flip(0.4) @ "pick"
                out = b0.switch(b1)(
                    jnp.int32(idx), (carry,), (carry,)
                ) @ "sw"
                return out * 0.5, out

            return step.scan(n=3), (0.5, jnp.zeros(3))
        if structure == "vmap_of_mask":
            @g.gen
            def inner(shift):
                return g.normal(shift, 1.0) @ "a"

            return inner.mask().vmap(in_axes=(0, 0)), (
                jnp.array([True, False, True]), jnp.arange(3.0))
        if structure == "repeat":
            @g.gen
            def inner(shift):
                return g.normal(shift, 1.0) @ "a"

            return inner.repeat(n=4), (0.5,)
        if structure == "dimap":
            @g.gen
            def inner(shift):
                a = g.normal(shift, 1.0) @ "a"
                b = g.gamma(2.0, 2.0) @ "b"
                return a + b

            return inner.dimap(
                pre=lambda s: (s * 2.0,),
                post=lambda args, r: r - 1.0,
            ), (0.25,)
        raise ValueError(structure)

    @pytest.mark.parametrize(
        "structure",
        ["scan_of_switch", "vmap_of_mask", "repeat", "dimap"],
    )
    def test_identities(self, structure):
        model, args = self._make(structure)
        for seed in range(3):
            key = jax.random.key(seed * 13 + 5)
            tr = model.simulate(key, args)
            score = float(tr.get_score())
            chm = tr.get_choices()
            s2, _ = model.assess(chm, args)
            np.testing.assert_allclose(float(s2), score, rtol=1e-5,
                                       atol=1e-6)
            _, w = model.generate(jax.random.fold_in(key, 1), chm, args)
            np.testing.assert_allclose(float(w), score, rtol=1e-5,
                                       atol=1e-6)
            _, wu, _, _ = tr.edit(
                jax.random.fold_in(key, 2), Update(chm)
            )
            np.testing.assert_allclose(float(wu), 0.0, atol=1e-5)
