"""mxu_dot: bf16-operand / f32-accumulation contraction (ops/mxu.py).

CPU tests pin the numerical contract (output dtype f32, error bounded by
bf16 operand rounding, custom-VJP gradients matching f32 AD within the
same bound) across ranks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from genjax_xla.ops import mxu_dot

KEY = jax.random.key(42)


def _relerr(a, b):
    denom = np.maximum(np.max(np.abs(np.asarray(b))), 1e-30)
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))) / denom)


class TestForward:
    def test_matvec_f32_out_and_bf16_error_bound(self):
        X = jax.random.normal(KEY, (128, 64))
        w = jax.random.normal(jax.random.fold_in(KEY, 1), (64,))
        out = mxu_dot(X, w)
        assert out.dtype == jnp.float32
        assert out.shape == (128,)
        # bf16 has an 8-bit mantissa: per-operand rounding is <= 2^-8
        # relative, and the K=64 f32-accumulated contraction keeps the
        # result within a small multiple of that.
        assert _relerr(out, X @ w) < 0.02

    @pytest.mark.parametrize(
        "ashape,bshape",
        [((8, 16), (16, 4)), ((3, 5, 16), (16,)), ((2, 4, 8), (8, 3, 2))],
    )
    def test_rank_combinations(self, ashape, bshape):
        a = jax.random.normal(KEY, ashape)
        b = jax.random.normal(jax.random.fold_in(KEY, 2), bshape)
        out = mxu_dot(a, b)
        ref = jnp.tensordot(a, b, axes=1)
        assert out.shape == ref.shape
        assert _relerr(out, ref) < 0.03


class TestGradients:
    def test_param_grad_matches_f32(self):
        X = jax.random.normal(KEY, (256, 32))
        w = jax.random.normal(jax.random.fold_in(KEY, 3), (32,))
        y = (jax.random.uniform(jax.random.fold_in(KEY, 4), (256,))
             < 0.5).astype(jnp.float32)

        def loss(w, dot):
            logits = dot(X, w)
            return -jnp.sum(
                y * jax.nn.log_sigmoid(logits)
                + (1 - y) * jax.nn.log_sigmoid(-logits)
            )

        g = jax.grad(lambda w: loss(w, mxu_dot))(w)
        g_ref = jax.grad(lambda w: loss(w, lambda a, b: a @ b))(w)
        assert g.dtype == jnp.float32
        assert _relerr(g, g_ref) < 0.02

    def test_both_operand_grads(self):
        a = jax.random.normal(KEY, (6, 9))
        b = jax.random.normal(jax.random.fold_in(KEY, 5), (9, 7))
        ga, gb = jax.grad(
            lambda a, b: jnp.sum(mxu_dot(a, b) ** 2), argnums=(0, 1)
        )(a, b)
        ra, rb = jax.grad(
            lambda a, b: jnp.sum((a @ b) ** 2), argnums=(0, 1)
        )(a, b)
        assert ga.shape == a.shape and gb.shape == b.shape
        assert _relerr(ga, ra) < 0.03
        assert _relerr(gb, rb) < 0.03

    def test_value_and_grad_under_vmap_and_jit(self):
        X = jax.random.normal(KEY, (64, 16))
        ws = jax.random.normal(jax.random.fold_in(KEY, 6), (8, 16))

        f = jax.jit(jax.vmap(jax.value_and_grad(
            lambda w: jnp.sum(jnp.tanh(mxu_dot(X, w)))
        )))
        vals, grads = f(ws)
        assert vals.shape == (8,) and grads.shape == (8, 16)
        assert np.isfinite(np.asarray(vals)).all()
        assert np.isfinite(np.asarray(grads)).all()


def test_contraction_mismatch_raises():
    """ADVICE r4: a mismatched contraction dim gets an explicit error,
    not a confusing trailing-reshape failure."""
    import pytest

    a = jnp.zeros((4, 5))
    b = jnp.zeros((6, 3))
    with pytest.raises(ValueError, match="contraction mismatch"):
        from genjax_xla.ops.mxu import mxu_dot

        mxu_dot(a, b)
