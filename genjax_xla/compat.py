"""Migration/compat shims for code written against the reference.

Parity targets:
- ``implicit_logit_warning``:
  ``/root/reference/src/genjax/_src/generative_functions/distributions/
  distribution.py:479-500`` — early reference versions interpreted bare
  parameters of ``bernoulli``/``categorical`` as logits; a bare
  positional parameter now warns and asks for an explicit ``logits=`` /
  ``probs=`` choice.
- ``genjax_xla.experimental``: the reference ships an (empty)
  ``genjax.experimental`` facade (``src/genjax/experimental.py``);
  mirrored for drop-in imports.

See ``docs/MIGRATION.md`` for the full API-delta table.
"""

from __future__ import annotations

import textwrap
import warnings
from typing import Any, Callable

import jax.numpy as jnp

__all__ = ["implicit_logit_warning"]


def _default_probs_to_logits(probs):
    p = jnp.asarray(probs)
    if p.ndim >= 1:
        # Vector parameter (categorical-style): logits = log p.
        return jnp.log(p)
    # Scalar success probability (bernoulli-style): log-odds.
    return jnp.log(p) - jnp.log1p(-p)


def implicit_logit_warning(
    dist: Any,
    probs_to_logits: Callable = _default_probs_to_logits,
) -> Callable:
    """Wrap a logits-parameterized distribution so that a BARE positional
    parameter provokes a :class:`DeprecationWarning` (and is interpreted
    as logits, preserving old program meaning), while explicit
    ``logits=`` / ``probs=`` keywords select the scale unambiguously.

    ``dist`` is any callable distribution object (the repo's
    ``exact_density`` singletons included — the wrapper forwards to it,
    so ``@``-addressing of the returned closure still works)."""

    def wrapper(*args, **kwargs):
        if "probs" in kwargs:
            if args or "logits" in kwargs:
                raise TypeError(
                    "pass exactly one of a bare parameter, logits=, or "
                    "probs="
                )
            return dist(probs_to_logits(kwargs.pop("probs")), **kwargs)
        if "logits" in kwargs:
            if args:
                raise TypeError(
                    "pass exactly one of a bare parameter, logits=, or "
                    "probs="
                )
            return dist(kwargs.pop("logits"), **kwargs)
        if args:
            warnings.warn(
                textwrap.dedent(
                    f"""
                    The use of a bare argument to {getattr(dist, 'name', dist)}
                    is deprecated. Please specify `logits=` or `probs=` for the
                    parameters. The default, which will be used in this case,
                    is logits."""
                ),
                DeprecationWarning,
                stacklevel=2,
            )
        return dist(*args, **kwargs)

    wrapper.inner = dist
    return wrapper
