"""Staging utilities: trace Python callables to jaxprs (cached), FLOP-free
shape evaluation, concrete-flag short-circuit ops, and pytree selection.

Parity target: ``/root/reference/src/genjax/_src/core/compiler/staging.py``
(``stage``, ``FlagOp``, ``tree_choose``, ``multi_switch``, ``to_shape_fn``,
``empty_trace``) — re-implemented for JAX 0.9 APIs.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Sequence

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
from jax import lax

from genjax_xla.core.typing import Flag, static_check_is_concrete

__all__ = [
    "stage",
    "get_shaped_aval",
    "FlagOp",
    "tree_choose",
    "multi_switch",
    "to_shape_fn",
    "empty_value",
    "empty_trace",
]


def get_shaped_aval(x):
    return jax.api_util.shaped_abstractify(x)


def stage(fn: Callable, **params):
    """Stage ``fn`` to a ``ClosedJaxpr``.

    Returns a wrapped function: ``wrapped(*args) -> (closed_jaxpr,
    (in_tree, out_tree, out_shape))``.
    """

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        closed_jaxpr, out_shape = jax.make_jaxpr(
            functools.partial(fn, **kwargs), return_shape=True
        )(*args)
        in_tree = jtu.tree_structure(args)
        out_tree = jtu.tree_structure(out_shape)
        return closed_jaxpr, (in_tree, out_tree, out_shape)

    return wrapped


class FlagOp:
    """Boolean ops over possibly-concrete flags, with concrete short-circuit
    fast paths so that statically-known conditions stay out of the compiled
    program. Parity: reference ``staging.py:55-180``.
    """

    @staticmethod
    def concrete_true(f: Flag) -> bool:
        """True iff the flag is the *Python literal* ``True``. Concrete bool
        arrays deliberately do not fold (their Mask structure must survive
        jit boundaries with consistent pytree shapes)."""
        return f is True

    @staticmethod
    def concrete_false(f: Flag) -> bool:
        return f is False

    @staticmethod
    def and_(a: Flag, b: Flag) -> Flag:
        if isinstance(a, bool) and isinstance(b, bool):
            return a and b
        if a is False or b is False:
            return False
        if a is True:
            return b
        if b is True:
            return a
        return jnp.logical_and(a, b)

    @staticmethod
    def or_(a: Flag, b: Flag) -> Flag:
        if isinstance(a, bool) and isinstance(b, bool):
            return a or b
        if a is True or b is True:
            return True
        if a is False:
            return b
        if b is False:
            return a
        return jnp.logical_or(a, b)

    @staticmethod
    def xor_(a: Flag, b: Flag) -> Flag:
        if isinstance(a, bool) and isinstance(b, bool):
            return a != b
        return jnp.logical_xor(a, b)

    @staticmethod
    def not_(a: Flag) -> Flag:
        if isinstance(a, bool):
            return not a
        return jnp.logical_not(a)

    @staticmethod
    def where(flag: Flag, t, f):
        """Elementwise select with concrete fast path."""
        if flag is True:
            return t
        if flag is False:
            return f
        return jnp.where(flag, t, f)

    @staticmethod
    def cond(flag: Flag, tf: Callable, ff: Callable, *args):
        """Functional conditional with concrete fast path."""
        if flag is True:
            return tf(*args)
        if flag is False:
            return ff(*args)
        return lax.cond(flag, tf, ff, *args)


def tree_choose(idx, pytrees: Sequence[Any]):
    """Select one pytree among ``pytrees`` by (possibly traced) index.

    Concrete ``idx`` short-circuits to a Python indexing operation; traced
    ``idx`` lowers to a per-leaf ``jnp.choose``-style select so the whole
    selection stays inside XLA. Parity: reference ``staging.py:187-218``.
    """
    if static_check_is_concrete(idx) and isinstance(idx, (int,)):
        return pytrees[idx]

    def chooser(*leaves):
        stacked = jnp.stack(
            [jnp.asarray(l) for l in leaves], axis=0
        )
        out = jnp.take(stacked, jnp.asarray(idx, dtype=jnp.int32), axis=0, mode="clip")
        return out.astype(stacked.dtype)

    return jtu.tree_map(chooser, *pytrees)


def multi_switch(idx, branches: Sequence[Callable], arg_tuples: Sequence[tuple]):
    """``lax.switch`` over branches with *heterogeneous* output shapes.

    Each branch ``branches[i]`` is called (abstractly) on ``arg_tuples[i]`` to
    determine its output shape; the switched program computes, for the taken
    branch, its real output and zero placeholders for the others. Returns the
    list of per-branch outputs (taken branch real, others zeros).

    Parity: reference ``staging.py:221-254``.
    """
    shapes = [
        jax.eval_shape(b, *args) for b, args in zip(branches, arg_tuples)
    ]
    _arg_trees = [jtu.tree_structure(a) for a in arg_tuples]

    def make_setter(i):
        def setter(args_flat_all):
            outs = []
            for j, shp in enumerate(shapes):
                if j == i:
                    args = jtu.tree_unflatten(_arg_trees[j], args_flat_all[j])
                    outs.append(branches[j](*args))
                else:
                    outs.append(
                        jtu.tree_map(
                            lambda s: jnp.zeros(s.shape, s.dtype), shapes[j]
                        )
                    )
            return tuple(outs)

        return setter

    args_flat_all = [jtu.tree_leaves(a) for a in arg_tuples]

    if static_check_is_concrete(idx) and isinstance(idx, int):
        result = make_setter(idx)(args_flat_all)
    else:
        result = lax.switch(
            idx, [make_setter(i) for i in range(len(branches))], args_flat_all
        )
    return list(result)


def to_shape_fn(fn: Callable, fill: Callable | None = None) -> Callable:
    """Wrap ``fn`` so it evaluates shapes only (no FLOPs); optionally fill
    the resulting ``ShapeDtypeStruct`` pytree with ``fill(shape, dtype)``.

    Parity: reference ``staging.py:301-329``.
    """

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        shape = jax.eval_shape(fn, *args, **kwargs)
        if fill is not None:
            return jtu.tree_map(lambda s: fill(s.shape, s.dtype), shape)
        return shape

    return wrapped


def empty_value(fn: Callable, *args, **kwargs):
    """Zero-filled pytree matching ``fn(*args)``'s output structure."""
    return to_shape_fn(fn, jnp.zeros)(*args, **kwargs)


def empty_trace(gen_fn, args: tuple):
    """A zero-filled trace for ``gen_fn`` on ``args`` — no sampling, no FLOPs.

    Parity: reference ``staging.py:332-347``.
    """
    key = jax.random.key(0)
    return to_shape_fn(gen_fn.simulate, jnp.zeros)(key, args)
