"""Branch-dependent support transforms through Switch choice maps
(VERDICT r1 item 8): gated fldj, PerBranch inference, NUTS end-to-end on
a model containing Switch, and vmapped-Switch choice-map round-trips."""

import jax
import jax.numpy as jnp
import numpy as np

import genjax_xla as g
from genjax_xla.gfi.choice_map import lanes_leading, partition_values
from genjax_xla.inference import Target
from genjax_xla.inference.adaptation import run_nuts
from genjax_xla.inference.transforms import (
    PerBranch,
    constrain_choices,
    infer_transforms,
    positive,
    unconstrain_choices,
)

KEY = jax.random.key(20260817)


@g.gen
def _b_normal():
    return g.normal(0.0, 1.0) @ "x"


@g.gen
def _b_gamma():
    return g.gamma(2.0, 1.0) @ "x"


_sw = g.switch(_b_normal, _b_gamma)


@g.gen
def _model(idx):
    x = _sw(idx, (), ()) @ "sw"
    _ = g.normal(x, 0.5) @ "y"


class TestInferTransforms:
    def test_per_branch_spec(self):
        """Same address, different supports per branch → PerBranch."""
        tr = _model.simulate(KEY, (jnp.asarray(1),))
        transforms = infer_transforms(tr)
        spec = transforms[("sw", "x")]
        assert isinstance(spec, PerBranch)
        assert spec.specs == (None, "positive")

    def test_agreeing_branches_plain_spec(self):
        @g.gen
        def c0():
            return g.gamma(1.0, 1.0) @ "x"

        @g.gen
        def c1():
            return g.exponential(2.0) @ "x"

        sw = g.switch(c0, c1)

        @g.gen
        def m(idx):
            return sw(idx, (), ()) @ "sw"

        tr = m.simulate(KEY, (jnp.asarray(0),))
        transforms = infer_transforms(tr)
        assert transforms[("sw", "x")] == "positive"


class TestGatedFldj:
    def _latents(self, idx):
        tr = _model.simulate(KEY, (jnp.asarray(idx),))
        target = Target(_model, (jnp.asarray(idx),),
                        g.C["y"].set(jnp.asarray(0.7)))
        chm = target.filter_to_unconstrained(tr.get_choices())
        return tr, chm

    def test_fldj_gated_by_branch(self):
        """fldj is the softplus Jacobian when the gamma branch is live,
        exactly zero when the normal branch is."""
        transforms = {("sw", "x"): PerBranch((None, "positive"))}
        for idx, expect_positive in [(0, False), (1, True)]:
            _, chm = self._latents(idx)
            u_chm = unconstrain_choices(chm, transforms)
            x_chm, fldj = constrain_choices(u_chm, transforms)
            if expect_positive:
                # Live gamma leaf: u = softplus^-1(x), fldj = log σ(u).
                x_live = chm["sw", "x"]
                x_live = x_live.unmask() if isinstance(
                    x_live, g.Mask) else x_live
                u = positive.inverse(x_live)
                np.testing.assert_allclose(
                    float(fldj), float(jax.nn.log_sigmoid(u)), rtol=1e-5
                )
                rt = x_chm["sw", "x"]
                rt = rt.unmask() if isinstance(rt, g.Mask) else rt
                np.testing.assert_allclose(
                    float(rt), float(x_live), rtol=1e-5
                )
            else:
                np.testing.assert_allclose(float(fldj), 0.0, atol=1e-6)

    def test_score_preserved_through_roundtrip(self):
        """assess() on the round-tripped constrained chm reproduces the
        original trace score (live-branch leaves round-trip exactly)."""
        transforms = {("sw", "x"): PerBranch((None, "positive"))}
        for idx in (0, 1):
            tr = _model.simulate(KEY, (jnp.asarray(idx),))
            chm = tr.get_choices()
            u_chm = unconstrain_choices(chm, transforms)
            x_chm, _ = constrain_choices(u_chm, transforms)
            score, _ = _model.assess(x_chm, (jnp.asarray(idx),))
            np.testing.assert_allclose(
                float(score), float(tr.get_score()), rtol=1e-5
            )


class TestPartitionValues:
    def test_switch_idx_not_in_values(self):
        from jax.flatten_util import ravel_pytree

        tr = _model.simulate(KEY, (jnp.asarray(1),))
        chm = tr.get_choices()
        vals, rebuild = partition_values(chm)
        flat, _ = ravel_pytree(vals)
        # Leaves: x0, x1 (per branch) and y — the int idx must NOT be
        # folded into a position vector.
        assert flat.shape == (3,)
        assert jnp.issubdtype(flat.dtype, jnp.floating)
        rt = rebuild(vals)
        score, _ = _model.assess(rt, (jnp.asarray(1),))
        np.testing.assert_allclose(
            float(score), float(tr.get_score()), rtol=1e-6
        )


class TestNutsOnSwitch:
    def test_posterior_matches_no_switch_model(self):
        """NUTS + auto transforms on the Switch model (gamma branch live,
        traced idx) agrees with NUTS on the equivalent plain model."""
        y_obs = jnp.asarray(1.3)

        @g.gen
        def plain():
            x = g.gamma(2.0, 1.0) @ "x"
            _ = g.normal(x, 0.5) @ "y"

        def run(target, key, addr):
            chms, _ = jax.jit(
                lambda k: run_nuts(
                    target, k, n_chains=2, num_warmup=200,
                    num_samples=400, max_depth=6, transforms="auto",
                )
            )(key)
            v = chms[addr]
            v = v.unmask() if isinstance(v, g.Mask) else v
            return np.asarray(v)

        sw_target = Target(
            _model, (jnp.asarray(1),), g.C["y"].set(y_obs)
        )
        plain_target = Target(plain, (), g.C["y"].set(y_obs))
        xs_sw = run(sw_target, KEY, ("sw", "x"))
        xs_plain = run(plain_target, jax.random.key(7), "x")
        assert np.isfinite(xs_sw).all()
        assert (xs_sw > 0.0).all()
        assert abs(xs_sw.mean() - xs_plain.mean()) < 0.12
        assert abs(xs_sw.std() - xs_plain.std()) < 0.12

    def test_normal_branch_conjugate(self):
        """idx=0 (normal branch, identity transform): posterior is the
        exact normal-normal conjugate."""
        y_obs = jnp.asarray(0.8)
        target = Target(_model, (jnp.asarray(0),), g.C["y"].set(y_obs))
        chms, _ = jax.jit(
            lambda k: run_nuts(
                target, k, n_chains=2, num_warmup=200, num_samples=400,
                max_depth=6, transforms="auto",
            )
        )(KEY)
        xs = chms["sw", "x"]
        xs = xs.unmask() if isinstance(xs, g.Mask) else xs
        xs = np.asarray(xs)
        # Prior N(0,1), likelihood N(x, 0.5): posterior precision 1+4.
        post_var = 1.0 / (1.0 + 1.0 / 0.25)
        post_mean = post_var * (y_obs / 0.25)
        assert abs(xs.mean() - float(post_mean)) < 0.08
        assert abs(xs.std() - float(np.sqrt(post_var))) < 0.08


class TestLanesLeadingSwitch:
    def test_vmapped_switch_roundtrip(self):
        """Choice maps simulated through jax.vmap over a batch of keys
        (Switch inside) restore lane-major layout and look up per-lane
        values matching per-instance simulation."""
        idxs = jnp.asarray([0, 1, 1, 0])
        keys = jax.random.split(KEY, 4)

        chm_b = jax.vmap(
            lambda k, i: _model.simulate(k, (i,)).get_choices()
        )(keys, idxs)
        fixed = lanes_leading(chm_b, 1)

        for lane in range(4):
            tr = _model.simulate(keys[lane], (idxs[lane],))
            want = tr.get_choices()["sw", "x"]
            want = want.unmask() if isinstance(want, g.Mask) else want
            got = fixed["sw", "x"]
            got = got.unmask() if isinstance(got, g.Mask) else got
            np.testing.assert_allclose(
                np.asarray(got)[lane], np.asarray(want), rtol=1e-6
            )


class TestTransformsReviewRegressions:
    """Late round-2 self-review fixes."""

    def _nested(self):
        @g.gen
        def n0():
            return g.normal(0.0, 1.0) @ "x"

        @g.gen
        def n1():
            return g.normal(1.0, 1.0) @ "x"

        @g.gen
        def gm():
            return g.gamma(2.0, 2.0) @ "x"

        @g.gen
        def inner_m(i):
            return g.switch(n0, n1)(i, (), ()) @ "isw"

        outer = g.switch(inner_m, gm)

        @g.gen
        def model(oi, ii):
            return outer(oi, (ii,), ()) @ "sw"

        return model

    @staticmethod
    def _unwrap(v):
        from genjax_xla.gfi.mask import Mask

        while isinstance(v, Mask):
            v = v.value
        return v

    def test_nested_switch_perbranch_levels(self):
        """PerBranch layers peel outer-first: the live plain-normal
        leaf under a nested Switch gets the identity bijector (the old
        innermost-branch indexing applied the gamma's softplus to it —
        fldj was nonzero and the geometry warped)."""
        model = self._nested()
        tr = model.simulate(
            jax.random.key(0), (jnp.asarray(0), jnp.asarray(1))
        )
        t = infer_transforms(tr)
        chm = tr.get_choices()
        u = unconstrain_choices(chm, t)
        x2, fldj = constrain_choices(u, t)
        v0 = self._unwrap(chm.get_submap("sw", "isw", "x").get_value())
        v1 = self._unwrap(x2.get_submap("sw", "isw", "x").get_value())
        assert jnp.allclose(v0, v1, atol=1e-5)
        assert float(fldj) == 0.0  # identity on the live leaf

    def test_oob_switch_idx_clamps(self):
        """Transform liveness gates follow the Switch's documented
        clamping (an OOB idx previously marked every branch dead,
        corrupting values and dropping fldj)."""
        model = self._nested()
        tr = model.simulate(
            jax.random.key(0), (jnp.asarray(5), jnp.asarray(0))
        )
        t = infer_transforms(tr)
        chm = tr.get_choices()
        u = unconstrain_choices(chm, t)
        x2, fldj = constrain_choices(u, t)
        v0 = self._unwrap(chm.get_submap("sw", "x").get_value())
        v1 = self._unwrap(x2.get_submap("sw", "x").get_value())
        assert jnp.allclose(v0, v1, atol=1e-5)
        assert float(fldj) != 0.0  # the gamma leaf is live

    def test_vector_arg_uniform_branches(self):
        """Array-valued interval bounds no longer crash the branch
        support merge ('truth value of an array is ambiguous')."""
        @g.gen
        def bu():
            return g.uniform(jnp.zeros(3), jnp.ones(3)) @ "x"

        @g.gen
        def model():
            return g.switch(bu, bu)(jnp.asarray(0), (), ()) @ "sw"

        tr = model.simulate(jax.random.key(0), ())
        t = infer_transforms(tr)
        assert ("sw", "x") in t

    def test_filtered_subtree_fldj_gated(self):
        """A filtered-out subtree's transformed leaf contributes 0 to
        fldj (the lazy Filtered descent previously went ungated)."""
        @g.gen
        def n0():
            return g.normal(0.0, 1.0) @ "x"

        @g.gen
        def model():
            return g.switch(n0, n0)(jnp.asarray(0), (), ()) @ "sw"

        tr = model.simulate(jax.random.key(0), ())
        dead = tr.get_choices().filter(jnp.asarray(False))
        _, fldj = constrain_choices(dead, {("sw", "x"): "positive"})
        assert float(fldj) == 0.0
        live = tr.get_choices().filter(jnp.asarray(True))
        _, fldj2 = constrain_choices(live, {("sw", "x"): "positive"})
        assert float(fldj2) != 0.0

    def test_unit_interval_spec(self):
        from genjax_xla.inference.transforms import get_bijector
        import pytest

        b = get_bijector("unit_interval")
        assert float(b.forward(jnp.asarray(0.0))) == 0.5
        with pytest.raises(ValueError, match="Unknown bijector"):
            get_bijector("nope")
