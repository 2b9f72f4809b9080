"""ADEV gradient-estimator exactness tests against closed-form derivatives
of expectations. Mirrors ``/root/reference/tests/adev/test_adev.py``
(:21-52 enumeration exactness, :78-99 baseline equivalence).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from genjax_xla.adev import (
    Dual,
    add_cost,
    baseline,
    categorical_enum_parallel,
    expectation,
    flip_enum,
    flip_enum_parallel,
    flip_mvd,
    flip_reinforce,
    mv_normal_diag_reparam,
    normal_reinforce,
    normal_reparam,
)

KEY = jax.random.key(314159)


class TestEnumExact:
    def test_flip_enum_exact_grad(self):
        @expectation
        def loss(p):
            b = flip_enum(p)
            return jnp.where(b, 3.0, -1.0)

        # E = p*3 + (1-p)*(-1); dE/dp = 4 exactly, any key.
        for k in range(3):
            grad = loss.grad_estimate(jax.random.key(k), (0.3,))
            assert jnp.allclose(grad[0], 4.0)

    def test_flip_enum_parallel(self):
        @expectation
        def loss(p):
            b = flip_enum_parallel(p)
            return jnp.where(b, 2.0, 1.0)

        grad = loss.grad_estimate(KEY, (0.7,))
        assert jnp.allclose(grad[0], 1.0)

    def test_flip_mvd_exact(self):
        @expectation
        def loss(p):
            b = flip_mvd(p)
            return jnp.where(b, 3.0, -1.0)

        grad = loss.grad_estimate(KEY, (0.3,))
        assert jnp.allclose(grad[0], 4.0)

    def test_categorical_enum(self):
        @expectation
        def loss(logits):
            i = categorical_enum_parallel(logits)
            return jnp.asarray([1.0, 2.0, 4.0])[i]

        logits = jnp.log(jnp.array([0.2, 0.3, 0.5]))
        grad = loss.grad_estimate(KEY, (logits,))
        p = np.array([0.2, 0.3, 0.5])
        f = np.array([1.0, 2.0, 4.0])
        want = p * (f - (p * f).sum())
        np.testing.assert_allclose(np.asarray(grad[0]), want, rtol=1e-5)

    def test_estimate_value(self):
        @expectation
        def loss(p):
            b = flip_enum(p)
            return jnp.where(b, 3.0, -1.0)

        est = loss.estimate(KEY, (0.3,))
        assert jnp.allclose(est, 0.2, atol=1e-6)


class TestStochasticUnbiased:
    def test_reinforce_flip(self):
        @expectation
        def loss(p):
            b = flip_reinforce(p)
            return jnp.where(b, 3.0, -1.0)

        keys = jax.random.split(KEY, 4000)
        gs = jax.vmap(lambda k: loss.grad_estimate(k, (0.3,))[0])(keys)
        assert abs(float(gs.mean()) - 4.0) < 0.15

    def test_normal_reparam(self):
        @expectation
        def loss(mu):
            x = normal_reparam(mu, 1.0)
            return x * x

        keys = jax.random.split(KEY, 4000)
        gs = jax.vmap(lambda k: loss.grad_estimate(k, (1.5,))[0])(keys)
        assert abs(float(gs.mean()) - 3.0) < 0.1

    def test_normal_reinforce(self):
        @expectation
        def loss(mu):
            x = normal_reinforce(mu, 1.0)
            return x * x

        keys = jax.random.split(KEY, 8000)
        gs = jax.vmap(lambda k: loss.grad_estimate(k, (1.5,))[0])(keys)
        assert abs(float(gs.mean()) - 3.0) < 0.3

    def test_mv_normal_diag_reparam(self):
        @expectation
        def loss(loc):
            x = mv_normal_diag_reparam(loc, jnp.ones(2))
            return jnp.sum(x * x)

        keys = jax.random.split(KEY, 4000)
        gs = jax.vmap(
            lambda k: loss.grad_estimate(k, (jnp.array([1.0, -1.0]),))[0]
        )(keys)
        np.testing.assert_allclose(
            np.asarray(gs.mean(0)), [2.0, -2.0], atol=0.15
        )


class TestCombinators:
    def test_nested_samples(self):
        """Two sampling sites compose through the CPS chain."""

        @expectation
        def loss(p, mu):
            b = flip_enum(p)
            x = normal_reparam(jnp.where(b, mu, 0.0), 1.0)
            return x

        # E = p*mu; dE/dp = mu, dE/dmu = p.
        keys = jax.random.split(KEY, 2000)
        gs = jax.vmap(lambda k: loss.grad_estimate(k, (0.3, 2.0)))(keys)
        assert abs(float(gs[0].mean()) - 2.0) < 0.1
        assert abs(float(gs[1].mean()) - 0.3) < 0.05

    def test_add_cost(self):
        @expectation
        def loss(mu):
            x = normal_reparam(mu, 1.0)
            add_cost(10.0 * mu)
            return x

        grad = loss.grad_estimate(KEY, (1.0,))
        assert jnp.allclose(grad[0], 11.0, atol=1e-5)

    def test_baseline_equivalence(self):
        """A baseline changes variance, not the estimator's mean."""
        b_prim = baseline(flip_reinforce)

        @expectation
        def loss_base(p):
            b = b_prim(1.0, p)
            return jnp.where(b, 3.0, -1.0)

        keys = jax.random.split(KEY, 4000)
        gs = jax.vmap(lambda k: loss_base.grad_estimate(k, (0.3,))[0])(keys)
        assert abs(float(gs.mean()) - 4.0) < 0.15

    def test_jvp_estimate_dual(self):
        @expectation
        def loss(p):
            b = flip_enum(p)
            return jnp.where(b, 1.0, 0.0)

        dual = loss.jvp_estimate(
            KEY, (Dual(jnp.asarray(0.4), jnp.asarray(1.0)),)
        )
        assert jnp.allclose(dual.primal, 0.4)
        assert jnp.allclose(dual.tangent, 1.0)

    def test_cond_with_samples(self):
        """lax.cond branches containing sample sites go through the CPS
        branch transform."""

        @expectation
        def loss(p, mu):
            x = normal_reparam(mu, 1.0)

            def t_branch(mu):
                return normal_reparam(mu, 1.0) * 2.0

            def f_branch(mu):
                return mu * 0.0

            return jax.lax.cond(x > 0.0, t_branch, f_branch, mu)

        # Smoke: finite gradient.
        g = loss.grad_estimate(KEY, (0.5, 1.0))
        assert all(bool(jnp.isfinite(gi)) for gi in g)


class TestBatchedSites:
    def test_vmap_reparam_site_inside_program(self):
        """A vmapped reparam sample site keeps its pathwise gradient."""

        @expectation
        def loss(mu):
            xs = jax.vmap(lambda m: normal_reparam(m, 1.0))(
                mu * jnp.ones(8)
            )
            return jnp.mean(xs * xs)

        keys = jax.random.split(KEY, 2000)
        gs = jax.vmap(lambda k: loss.grad_estimate(k, (1.5,))[0])(keys)
        # d/dmu E[mean(x_i^2)] = 2 mu = 3.0
        assert abs(float(gs.mean()) - 3.0) < 0.1

    def test_vmap_reinforce_site_unbiased(self):
        """Batching a score-function site lifts to the multi-sample
        REINFORCE estimator (loss times summed score tangents):
        d/dp E[sum_i 1{b_i}] = n for n lanes."""

        @expectation
        def loss(p):
            bs = jax.vmap(lambda pp: flip_reinforce(pp))(p * jnp.ones(4))
            return jnp.sum(jnp.where(bs, 1.0, 0.0))

        keys = jax.random.split(KEY, 6000)
        gs = jax.vmap(lambda k: loss.grad_estimate(k, (0.3,))[0])(keys)
        assert abs(float(gs.mean()) - 4.0) < 0.25

    def test_vmap_normal_reinforce_matches_exact(self):
        """Continuous score-function under vmap: d/dmu E[sum_i x_i] = n."""

        @expectation
        def loss(mu):
            xs = jax.vmap(lambda m: normal_reinforce(m, 1.0))(
                mu * jnp.ones(3)
            )
            return jnp.sum(xs)

        keys = jax.random.split(KEY, 6000)
        gs = jax.vmap(lambda k: loss.grad_estimate(k, (0.5,))[0])(keys)
        assert abs(float(gs.mean()) - 3.0) < 0.3


class TestScanSites:
    def test_reparam_inside_scan_pathwise(self):
        """Reparameterized sites inside lax.scan differentiate pathwise
        (a random-walk guide): d/dmu E[x_T] = 1."""

        @expectation
        def loss(mu):
            def body(x, key_i):
                x_new = normal_reparam(x, 0.3)
                return x_new, None

            x_T, _ = jax.lax.scan(body, mu, jnp.arange(5))
            return x_T

        keys = jax.random.split(KEY, 500)
        gs = jax.vmap(lambda k: loss.grad_estimate(k, (1.0,))[0])(keys)
        assert abs(float(gs.mean()) - 1.0) < 0.05

    def test_reinforce_inside_scan_raises(self):
        import pytest

        @expectation
        def loss(p):
            def body(c, i):
                b = flip_reinforce(p)
                return c + jnp.where(b, 1.0, 0.0), None

            tot, _ = jax.lax.scan(body, 0.0, jnp.arange(3))
            return tot

        with pytest.raises(NotImplementedError):
            loss.grad_estimate(KEY, (0.3,))


class TestEnumUnderVmap:
    """Rao-Blackwellized per-lane enumeration lift (VERDICT r1 item 7):
    enumeration strategies inside a vmapped lane axis — the
    SMC-particles-around-guide pattern. Mirrors the reference's strategy
    tests (/root/reference/.../adev/primitives.py:183-254) under an outer
    vmap."""

    def test_vmapped_flip_enum_separable_exact(self):
        # Separable loss: the per-lane enum gradient is exact (the
        # conditioning on other lanes cancels since sum_k dp_k = 0).
        @expectation
        def loss(ps):
            bs = jax.vmap(flip_enum)(ps)
            return jnp.sum(jnp.where(bs, 3.0, -1.0))

        ps = jnp.array([0.3, 0.6, 0.9])
        for k in range(3):
            grad = loss.grad_estimate(jax.random.key(k), (ps,))
            np.testing.assert_allclose(
                np.asarray(grad[0]), 4.0 * np.ones(3), rtol=1e-5
            )

    def test_vmapped_flip_enum_coupled_unbiased(self):
        # Coupled (product) loss: estimator is unbiased, check the mean.
        @expectation
        def loss(ps):
            bs = jax.vmap(flip_enum)(ps)
            vals = jnp.where(bs, 2.0, 0.5)
            return jnp.prod(vals)

        ps = jnp.array([0.4, 0.7])
        # E = prod_i (2 p_i + .5 (1-p_i)); dE/dp_i = 1.5 * other factor.
        e0, e1 = 2 * 0.4 + 0.5 * 0.6, 2 * 0.7 + 0.5 * 0.3
        want = np.array([1.5 * e1, 1.5 * e0])
        keys = jax.random.split(KEY, 2000)
        gs = jax.vmap(lambda k: loss.grad_estimate(k, (ps,))[0])(keys)
        np.testing.assert_allclose(
            np.asarray(gs.mean(axis=0)), want, atol=0.05
        )

    def test_vmapped_categorical_enum_separable_exact(self):
        @expectation
        def loss(logits):
            idx = jax.vmap(categorical_enum_parallel)(logits)
            f = jnp.asarray([1.0, 2.0, 4.0])
            return jnp.sum(f[idx])

        logits = jnp.log(jnp.array([[0.2, 0.3, 0.5], [0.5, 0.25, 0.25]]))
        grad = loss.grad_estimate(KEY, (logits,))
        p = np.exp(np.asarray(logits))
        f = np.array([1.0, 2.0, 4.0])
        want = p * (f[None, :] - (p * f).sum(axis=1, keepdims=True))
        np.testing.assert_allclose(np.asarray(grad[0]), want, rtol=1e-4)

    def test_vmapped_enum_with_downstream_reparam(self):
        # Enum lanes feeding a reparameterized site: both tangent paths.
        @expectation
        def loss(ps, mu):
            bs = jax.vmap(flip_enum)(ps)
            shift = jnp.sum(jnp.where(bs, 1.0, 0.0))
            x = normal_reparam(mu + shift, 0.1)
            return x

        ps = jnp.array([0.2, 0.8])
        keys = jax.random.split(KEY, 500)
        gs = jax.vmap(
            lambda k: jnp.stack(
                jax.tree_util.tree_leaves(
                    loss.grad_estimate(k, (ps, 0.5))
                )[0]
            )
        )(keys)
        # E[x] = mu + sum p_i; d/dp_i = 1 exactly per lane.
        np.testing.assert_allclose(
            np.asarray(gs.mean(axis=0)), np.ones(2), atol=0.03
        )


class TestFlipCondExactness:
    """Parity: reference ``tests/adev/test_adev.py``
    ``test_flip_cond_exact_{forward,reverse}_mode_correctness`` — the
    enumerated-flip + lax.cond loss has exact derivative p - 1/2."""

    def test_forward_mode(self):
        @expectation
        def flip_exact_loss(p):
            b = flip_enum(p)
            return jax.lax.cond(b, lambda _: 0.0, lambda p: -p / 2.0, p)

        key = jax.random.key(314159)
        for p in [0.1, 0.3, 0.5, 0.7, 0.9]:
            d = jax.jit(flip_exact_loss.jvp_estimate)(key, Dual(p, 1.0))
            assert float(d.tangent) == pytest.approx(p - 0.5, rel=1e-4)

    def test_reverse_mode(self):
        @expectation
        def flip_exact_loss(p):
            b = flip_enum(p)
            return jax.lax.cond(b, lambda _: 0.0, lambda p: -p / 2.0, p)

        key = jax.random.key(314159)
        for p in [0.1, 0.3, 0.7]:
            gr = jax.jit(flip_exact_loss.grad_estimate)(key, (p,))
            assert float(gr[0]) == pytest.approx(p - 0.5, abs=1e-4)


class TestReviewRegressions:
    """Late round-2 self-review fixes."""

    def test_add_cost_on_pure_continuation(self):
        """MVD/enum pure continuations must include downstream
        add_cost terms: with flip strategies the derivative of
        E[f(b)] + c w.r.t. p is exactly f(T) - f(F), independent of
        the constant cost c (the old pure path dropped c, biasing the
        difference estimator by ±c)."""
        @expectation
        def loss_mvd(p):
            b = flip_mvd(p)
            add_cost(5.0)
            return jax.lax.cond(b, lambda: 1.0, lambda: 0.3)

        key = jax.random.key(314159)
        for k in range(6):
            d = loss_mvd.jvp_estimate(
                jax.random.fold_in(key, k), Dual(0.4, 1.0)
            )
            assert float(d.tangent) == pytest.approx(0.7, abs=1e-5), k

        @expectation
        def loss_enum(p):
            b = flip_enum(p)
            add_cost(5.0)
            return jax.lax.cond(b, lambda: 1.0, lambda: 0.3)

        d = loss_enum.jvp_estimate(key, Dual(0.4, 1.0))
        assert float(d.tangent) == pytest.approx(0.7, abs=1e-5)
        # the primal includes the cost
        assert float(d.primal) == pytest.approx(
            0.4 * 1.0 + 0.6 * 0.3 + 5.0, abs=1e-5
        )

    def test_vmapped_reinforce_not_frozen(self):
        """Plain (non-interpreted) sampling of a vmapped REINFORCE
        site must honor the caller's key (previously rebound to the
        default key(0) — frozen across all keys)."""
        from genjax_xla.adev.core import sample_primitive
        from genjax_xla.adev import primitives as prims

        def draw(key):
            return jax.vmap(
                lambda p: sample_primitive(
                    prims.flip_reinforce, p, key=key
                ),
                in_axes=0,
            )(jnp.full(64, 0.5))

        a = draw(jax.random.key(1))
        b = draw(jax.random.key(2))
        assert not jnp.array_equal(a, b)

    def test_normal_reinforce_array_params_independent(self):
        """The sampler must broadcast eps over parameter shape (a
        scalar eps perfectly correlates components while the summed
        logpdf scores them as independent)."""
        from genjax_xla.adev import primitives as prims

        v = prims.normal_reinforce.sample(
            jax.random.key(0), jnp.zeros(8), jnp.ones(8)
        )
        assert v.shape == (8,)
        assert float(jnp.std(v)) > 1e-3  # not all-equal
        lp = prims.normal_reinforce.differentiable_logpdf(
            v, jnp.zeros(8), jnp.ones(8)
        )
        assert jnp.ndim(lp) == 0  # joint (summed) density


def test_reparam_in_scan_with_threaded_keys_exact():
    """The recommended scan pattern: scan over split keys and bind
    key=... per site — fresh eps per step AND per estimate. For the
    linear walk the pathwise gradient is exactly 1 per step."""
    from genjax_xla.adev import primitives as prims
    from genjax_xla.adev.core import sample_primitive

    @expectation
    def loss(mu, keys):
        def body(c, k):
            x = sample_primitive(prims.normal_reparam, mu, 1.0, key=k)
            return c + x, None

        tot, _ = jax.lax.scan(body, 0.0, keys)
        return tot

    keys = jax.random.split(jax.random.key(7), 3)
    d = loss.jvp_estimate(
        jax.random.key(0), (Dual(0.5, 1.0), Dual(keys, keys))
    )
    assert float(d.tangent) == pytest.approx(3.0, abs=1e-5)


class TestNestedVmap:
    """Nested vmap over lifted reparam/enum sites (VERDICT r2 item 4a):
    the SMC-particles-around-vectorized-guide pattern. Round 2 raised
    NotImplementedError here; now the batch rule re-lifts."""

    def test_nested_vmap_reparam_unbiased(self):
        @expectation
        def loss(mus):
            xs = jax.vmap(jax.vmap(lambda m: normal_reparam(m, 1.0)))(
                mus
            )
            return jnp.sum(xs**2)

        mus = jnp.array([[0.5, -1.0, 2.0], [1.5, 0.0, -0.5]])
        keys = jax.random.split(KEY, 4000)
        gs = jax.vmap(lambda k: loss.grad_estimate(k, (mus,))[0])(keys)
        # d/dmu_ij E[x_ij^2] = 2 mu_ij; estimates must VARY across keys.
        np.testing.assert_allclose(
            np.asarray(gs.mean(0)), 2.0 * np.asarray(mus), atol=0.15
        )
        assert float(gs.std()) > 0.01

    def test_nested_vmap_flip_enum_separable_exact(self):
        @expectation
        def loss(ps):
            bs = jax.vmap(jax.vmap(flip_enum))(ps)
            w = jnp.array([[3.0, 1.0], [2.0, 5.0]])
            return jnp.sum(jnp.where(bs, w, -w))

        ps = jnp.array([[0.3, 0.6], [0.8, 0.2]])
        grad = loss.grad_estimate(jax.random.key(1), (ps,))[0]
        want = 2.0 * np.array([[3.0, 1.0], [2.0, 5.0]])
        np.testing.assert_allclose(np.asarray(grad), want, rtol=1e-4)

    def test_nested_vmap_reparam_broadcast_inner(self):
        # Outer axis batched, inner arg unbatched (broadcast lanes).
        @expectation
        def loss(mu):
            def inner(m):
                return jnp.sum(
                    jax.vmap(lambda s: normal_reparam(m, s))(
                        jnp.ones(3)
                    )
                )

            return jnp.sum(jax.vmap(inner)(mu * jnp.ones(2)))

        keys = jax.random.split(KEY, 2000)
        gs = jax.vmap(lambda k: loss.grad_estimate(k, (0.7,))[0])(keys)
        # d/dmu E[sum of 6 N(mu,1) draws] = 6.
        np.testing.assert_allclose(float(gs.mean()), 6.0, atol=0.01)

    def test_nested_lanes_independent(self):
        # All lanes share mu=0: draws must be independent across BOTH
        # axes (a frozen/nested-aliased lift would correlate them).
        @expectation
        def loss(mu):
            xs = jax.vmap(jax.vmap(lambda m: normal_reparam(m, 1.0)))(
                mu * jnp.ones((4, 4))
            )
            return jnp.sum(xs) ** 2

        keys = jax.random.split(KEY, 3000)
        vals = jax.vmap(lambda k: loss.estimate(k, (0.0,)))(keys)
        # Var(sum of 16 iid N(0,1)) = 16; perfectly correlated would
        # give 256.
        assert abs(float(vals.mean()) - 16.0) < 2.0


class TestScanFreshKeys:
    """Round-2 hole 4b: a reparameterized site inside lax.scan with the
    default constant key drew the SAME eps every step and estimate.
    _rekey_call now threads fresh interpreter keys per iteration."""

    def test_scan_site_fresh_eps_per_step_and_estimate(self):
        @expectation
        def loss(mu):
            def body(c, _):
                x = normal_reparam(mu, 1.0)
                return c + x, None

            out, _ = jax.lax.scan(body, 0.0, None, length=3)
            return out**2

        keys = jax.random.split(KEY, 3000)
        vals = jax.vmap(lambda k: loss.estimate(k, (0.0,)))(keys)
        # E[(eps1+eps2+eps3)^2] = 3 with fresh eps; 9 if the three
        # steps alias one eps; zero variance if frozen across
        # estimates.
        assert abs(float(vals.mean()) - 3.0) < 0.3
        assert float(vals.std()) > 0.5

    def test_scan_site_gradient_unbiased(self):
        @expectation
        def loss(mu):
            def body(c, _):
                x = normal_reparam(mu, 1.0)
                return c + x, None

            out, _ = jax.lax.scan(body, 0.0, None, length=3)
            return out**2

        keys = jax.random.split(KEY, 3000)
        gs = jax.vmap(lambda k: loss.grad_estimate(k, (0.5,))[0])(keys)
        # d/dmu E[(3mu + S)^2] = 18 mu = 9 at mu=0.5.
        assert abs(float(gs.mean()) - 9.0) < 0.5
        assert float(gs.std()) > 0.5

    def test_scan_carried_user_keys_respected(self):
        """Keys the user explicitly threads through the scan CARRY are
        respected — not replaced by interpreter-derived keys (ADVICE
        r3): with all randomness user-keyed, estimates are bitwise
        deterministic across interpreter keys, and the key chain stays
        on the user's bitstream."""
        from genjax_xla.adev import primitives as prims
        from genjax_xla.adev.core import sample_primitive

        k0 = jax.random.key(42)

        @expectation
        def loss(mu):
            def body(c, _):
                tot, k = c
                k, sub = jax.random.split(k)
                x = sample_primitive(
                    prims.normal_reparam, mu, 1.0, key=sub
                )
                return (tot + x, k), None

            (tot, _), _ = jax.lax.scan(body, (0.0, k0), None, length=3)
            return tot**2

        d1 = loss.jvp_estimate(jax.random.key(0), (Dual(0.5, 1.0),))
        d2 = loss.jvp_estimate(jax.random.key(999), (Dual(0.5, 1.0),))
        assert float(d1.primal) == float(d2.primal)
        assert float(d1.tangent) == float(d2.tangent)
        # And the values really come from the user's key chain.
        k, tot = k0, 0.0
        for _ in range(3):
            k, sub = jax.random.split(k)
            tot += 0.5 + jax.random.normal(sub)
        assert float(d1.primal) == pytest.approx(float(tot) ** 2, rel=1e-6)

    def test_scan_default_key_still_rekeyed(self):
        """The round-2 fix is preserved: default-constant keys inside a
        scan still get fresh interpreter keys per estimate even with
        the taint pass active."""

        @expectation
        def loss(mu):
            def body(c, _):
                x = normal_reparam(mu, 1.0)
                return c + x, None

            out, _ = jax.lax.scan(body, 0.0, None, length=2)
            return out

        d1 = loss.jvp_estimate(jax.random.key(0), (Dual(0.0, 1.0),))
        d2 = loss.jvp_estimate(jax.random.key(1), (Dual(0.0, 1.0),))
        assert float(d1.primal) != float(d2.primal)

    def test_scan_over_explicit_keys_still_works(self):
        # User-threaded keys keep working (pathwise through the scan).
        @expectation
        def loss(mu):
            def body(x, key_i):
                return normal_reparam(x, 0.3), None

            x_T, _ = jax.lax.scan(body, mu, jnp.arange(5))
            return x_T

        keys = jax.random.split(KEY, 500)
        gs = jax.vmap(lambda k: loss.grad_estimate(k, (1.0,))[0])(keys)
        assert abs(float(gs.mean()) - 1.0) < 0.05


class TestRekeyContractProperties:
    """Property tests of the ADEV rekeying contract (VERDICT r4 item 9):
    across nested scan/vmap combinations, user-threaded keys (scan-carry
    chains, per-lane fold_ins) are BITWISE respected under jvp_estimate
    — same primal/tangent for any interpreter key, matching a plain-jax
    oracle replay of the user's key chain — while default/constant keys
    are freshened per interpreter key."""

    from hypothesis import given, settings
    from hypothesis import strategies as st

    @staticmethod
    def _build(structure, n_out, n_in, mu, k0, with_const_site):
        """An @expectation program summing user-keyed normal_reparam
        draws arranged per ``structure``; optionally adds one
        default-keyed site at the end."""
        from genjax_xla.adev import primitives as prims
        from genjax_xla.adev.core import sample_primitive

        @expectation
        def loss(mu):
            if structure == "scan_scan":
                def body_out(c, _):
                    def body_in(ci, _):
                        ti, ki = ci
                        ki, sub = jax.random.split(ki)
                        x = sample_primitive(
                            prims.normal_reparam, mu, 1.0, key=sub
                        )
                        return (ti + x, ki), None

                    ci, _ = jax.lax.scan(body_in, c, None, length=n_in)
                    return ci, None

                (tot, _), _ = jax.lax.scan(
                    body_out, (0.0, k0), None, length=n_out
                )
            elif structure == "vmap_scan":
                def lane(i):
                    k = jax.random.fold_in(k0, i)

                    def body(ci, _):
                        ti, ki = ci
                        ki, sub = jax.random.split(ki)
                        x = sample_primitive(
                            prims.normal_reparam, mu, 1.0, key=sub
                        )
                        return (ti + x, ki), None

                    (tot, _), _ = jax.lax.scan(
                        body, (0.0, k), None, length=n_in
                    )
                    return tot

                tot = jnp.sum(jax.vmap(lane)(jnp.arange(n_out)))
            else:  # scan_vmap
                def body(c, _):
                    ti, ki = c
                    ki, sub = jax.random.split(ki)
                    subs = jax.random.split(sub, n_in)
                    xs = jax.vmap(
                        lambda kk: sample_primitive(
                            prims.normal_reparam, mu, 1.0, key=kk
                        )
                    )(subs)
                    return (ti + jnp.sum(xs), ki), None

                (tot, _), _ = jax.lax.scan(
                    body, (0.0, k0), None, length=n_out
                )
            if with_const_site:
                tot = tot + normal_reparam(mu, 1.0)
            return tot

        return loss

    @staticmethod
    def _oracle(structure, n_out, n_in, mu, k0):
        """Plain-jax replay of the user key chain (no ADEV anywhere)."""
        tot = 0.0
        if structure == "scan_scan":
            k = k0
            for _ in range(n_out * n_in):
                k, sub = jax.random.split(k)
                tot += mu + float(jax.random.normal(sub))
        elif structure == "vmap_scan":
            for i in range(n_out):
                k = jax.random.fold_in(k0, i)
                for _ in range(n_in):
                    k, sub = jax.random.split(k)
                    tot += mu + float(jax.random.normal(sub))
        else:  # scan_vmap
            k = k0
            for _ in range(n_out):
                k, sub = jax.random.split(k)
                for kk in jax.random.split(sub, n_in):
                    tot += mu + float(jax.random.normal(kk))
        return tot

    @given(
        st.sampled_from(["scan_scan", "vmap_scan", "scan_vmap"]),
        st.integers(1, 3),
        st.integers(1, 3),
        st.integers(0, 2**16),
    )
    @settings(max_examples=10, deadline=None)
    def test_user_chain_bitwise_and_const_freshened(
        self, structure, n_out, n_in, seed
    ):
        mu = 0.7
        k0 = jax.random.key(seed)
        ik1, ik2 = jax.random.key(seed + 1), jax.random.key(seed + 7)

        # 1. All-user-keyed: bitwise identical across interpreter keys,
        # matching the oracle replay; tangent is exactly the site count
        # (pathwise x = mu + eps).
        loss = self._build(structure, n_out, n_in, mu, k0, False)
        d1 = loss.jvp_estimate(ik1, (Dual(mu, 1.0),))
        d2 = loss.jvp_estimate(ik2, (Dual(mu, 1.0),))
        assert float(d1.primal) == float(d2.primal)
        assert float(d1.tangent) == float(d2.tangent)
        n_sites = n_out * n_in
        assert float(d1.tangent) == pytest.approx(n_sites, abs=1e-5)
        oracle = self._oracle(structure, n_out, n_in, mu, k0)
        assert float(d1.primal) == pytest.approx(oracle, rel=1e-5)

        # 2. With a default-keyed site added, the interpreter freshens
        # it: primals differ across interpreter keys, and the user part
        # is still the oracle (difference is exactly the const draw).
        lossc = self._build(structure, n_out, n_in, mu, k0, True)
        c1 = lossc.jvp_estimate(ik1, (Dual(mu, 1.0),))
        c2 = lossc.jvp_estimate(ik2, (Dual(mu, 1.0),))
        assert float(c1.primal) != float(c2.primal)
        assert float(c1.tangent) == pytest.approx(n_sites + 1, abs=1e-5)
