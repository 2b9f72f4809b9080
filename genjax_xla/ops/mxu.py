"""bfloat16-operand contraction with float32 accumulation.

``mxu_dot(a, b)`` rounds both operands to bfloat16, multiplies them
with float32 accumulation (``preferred_element_type=float32``), and
returns float32. For inference workloads whose log-density is dominated
by a large data-matrix contraction (Bayesian logistic regression, BNN
likelihoods — benchmark configs 8/9), this perturbs the target density
by ~one part in 256 per operand entry; the perturbed density is still a
valid, deterministic MCMC/VI target — samplers draw from it exactly —
so the accuracy question is "is the perturbed posterior close?", which
the caller owns (the benchmark configs gate on posterior separation /
ELBO movement). Whether it is faster than a float32 product on a given
device is a measurement, not assumed here.

``mxu_dot`` routes BOTH the forward contraction and the two transpose
contractions of the backward pass through bfloat16 ``dot_general``s with
``preferred_element_type=float32`` (a ``custom_vjp``: plain AD of a cast
matmul would mix f32 cotangents with bf16 operands, which ``lax``
rejects). Unused operand cotangents (e.g. the data matrix under ``grad``
w.r.t. parameters only) are dead code XLA eliminates — the outer-product
term never materializes.

New scope relative to the reference (no mixed-precision path there; its
matmuls inherit TFP/XLA f32 — SURVEY §6 performance baseline).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["mxu_dot"]


def _bf16_mm(a2: jax.Array, b2: jax.Array) -> jax.Array:
    """(M, K) x (K, N) -> (M, N): bf16 operands, f32 accumulation."""
    return lax.dot_general(
        a2.astype(jnp.bfloat16),
        b2.astype(jnp.bfloat16),
        (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )


@jax.custom_vjp
def mxu_dot(a: jax.Array, b: jax.Array) -> jax.Array:
    """``a @ b`` (last dim of ``a`` against first dim of ``b``) with
    bfloat16 operands.

    Operands are rounded to bfloat16; accumulation and the result are
    float32. The backward pass contracts in bf16 too, so gradient
    matmuls (e.g. ``X.T @ residual`` in a leapfrog's value-and-grad)
    also take bfloat16 operands. Works for any ranks with the single
    shared contraction dim (internally canonicalized to 2-D).
    """
    if a.shape[-1] != b.shape[0]:
        raise ValueError(
            f"mxu_dot contraction mismatch: a.shape[-1]={a.shape[-1]} "
            f"!= b.shape[0]={b.shape[0]} (a.shape={a.shape}, "
            f"b.shape={b.shape})"
        )
    K = b.shape[0]
    out2 = _bf16_mm(a.reshape(-1, K), b.reshape(K, -1))
    return out2.reshape(*a.shape[:-1], *b.shape[1:])


def _fwd(a, b):
    return mxu_dot(a, b), (a, b)


def _bwd(res, g):
    a, b = res
    K = b.shape[0]
    a2 = a.reshape(-1, K)
    b2 = b.reshape(K, -1)
    g2 = g.reshape(a2.shape[0], b2.shape[1]).astype(jnp.float32)
    da = _bf16_mm(g2, b2.T).reshape(a.shape).astype(a.dtype)
    db = _bf16_mm(a2.T, g2).reshape(b.shape).astype(b.dtype)
    return da, db


mxu_dot.defvjp(_fwd, _bwd)
