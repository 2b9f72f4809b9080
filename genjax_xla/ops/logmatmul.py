"""Log-space matrix product.

``C[..., i, j] = logsumexp_k X[..., i, k] + Y[..., k, j]`` — the combine
step of parallel-prefix HMM filtering (``lax.associative_scan`` over
transition · observation operators) and of any log-space
linear-operator composition.

Computed as a max-shifted exponential matmul, so the contraction is one
ordinary (batched) matrix product with no ``S³`` broadcast intermediate.
The product runs at ``Precision.HIGHEST``: a float32 matmul may
otherwise run in TF32 on the GPU, whose 10-bit mantissa puts a relative
error of about 1e-3 on every log-space product — visible in the exact
oracles this operator serves.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["log_matmul"]


def log_matmul(X: jax.Array, Y: jax.Array) -> jax.Array:
    """Log-space product of ``(..., S, K)`` and ``(..., K, T)``, batched
    over leading dims."""
    rx = jnp.max(X, axis=-1, keepdims=True)
    cy = jnp.max(Y, axis=-2, keepdims=True)
    P = jnp.matmul(jnp.exp(X - rx), jnp.exp(Y - cy),
                   precision=lax.Precision.HIGHEST)
    tiny = jnp.finfo(P.dtype).tiny
    return jnp.log(jnp.maximum(P, tiny)) + rx + cy

