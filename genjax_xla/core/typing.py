"""Type vocabulary for the framework.

Parity target: ``/root/reference/src/genjax/_src/core/typing.py`` — but we do
not depend on jaxtyping/beartype; aliases are plain
``jax.Array`` / Python types, and the static checkers are small helpers.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence, TypeAlias, Union

import jax
import jax.core
import jax.numpy as jnp
import numpy as np

__all__ = [
    "PRNGKey",
    "IntArray",
    "FloatArray",
    "BoolArray",
    "ArrayLike",
    "Flag",
    "ScalarFlag",
    "Address",
    "AddressComponent",
    "static_check_is_concrete",
    "static_check_supports_grad",
    "to_float",
]

PRNGKey: TypeAlias = jax.Array
IntArray: TypeAlias = Union[int, jax.Array, np.ndarray]
FloatArray: TypeAlias = Union[float, jax.Array, np.ndarray]
BoolArray: TypeAlias = Union[bool, jax.Array, np.ndarray]
ArrayLike: TypeAlias = Union[bool, int, float, jax.Array, np.ndarray]

#: A possibly-vectorized boolean: concrete Python bool or a bool array.
Flag: TypeAlias = Union[bool, jax.Array, np.ndarray]
#: A scalar flag (no batch dims).
ScalarFlag: TypeAlias = Union[bool, jax.Array, np.ndarray]

#: Hierarchical trace addresses: strings, ints/arrays (dynamic), tuples.
AddressComponent: TypeAlias = Union[str, int, jax.Array, np.ndarray, slice]
Address: TypeAlias = Union[AddressComponent, tuple]

Callable = Callable  # re-export
Sequence = Sequence  # re-export


def static_check_is_concrete(x: Any) -> bool:
    """True iff ``x`` is a concrete (non-traced) value.

    Parity: reference ``typing.py:88``.
    """
    return not isinstance(x, jax.core.Tracer)


def static_check_supports_grad(v: Any) -> bool:
    """True iff ``v`` is a floating-point value (differentiable leaf)."""
    return jnp.issubdtype(jnp.result_type(v), jnp.floating)


def to_float(x: ArrayLike) -> jax.Array:
    return jnp.asarray(x, dtype=jnp.result_type(float))
