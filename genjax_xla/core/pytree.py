"""Pytree substrate: frozen dataclasses registered with JAX, with a static /
dynamic field split.

This is the L0 layer everything else builds on. Functional parity target:
``/root/reference/src/genjax/_src/core/pytree.py`` (``Pytree``,
``Pytree.dataclass/static/field``, ``Const``, ``Closure``, ``PythonicPytree``),
re-designed without the penzai dependency: we register dataclasses directly via
``jax.tree_util.register_dataclass`` (the C++ fast path in modern JAX), which
keeps flatten/unflatten off the Python hot path during tracing.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Generic, TypeVar

import jax.numpy as jnp
import jax.tree_util as jtu

R = TypeVar("R")
T = TypeVar("T")

__all__ = [
    "Pytree",
    "Const",
    "Closure",
    "PythonicPytree",
]


class Pytree:
    """Base class for JAX-pytree-compatible frozen dataclasses.

    Subclasses decorated with :func:`Pytree.dataclass` become frozen
    dataclasses registered as JAX pytrees. Fields declared with
    :func:`Pytree.static` are *metadata* (part of the treedef, must be
    hashable); all other fields are *data* (traced leaves / subtrees).

    Example::

        @Pytree.dataclass
        class Point(Pytree):
            x: jax.Array
            y: jax.Array
            name: str = Pytree.static(default="p")
    """

    @staticmethod
    def dataclass(
        incoming: type | None = None,
        /,
        **kwargs,
    ) -> type | Callable[[type], type]:
        """Class decorator: frozen dataclass + JAX pytree registration."""

        def wrap(cls: type) -> type:
            kwargs.setdefault("eq", False)
            dcls = dataclasses.dataclass(frozen=True, **kwargs)(cls)
            static_names = []
            data_names = []
            for f in dataclasses.fields(dcls):
                if f.metadata.get("pytree_static", False):
                    static_names.append(f.name)
                else:
                    data_names.append(f.name)
            jtu.register_dataclass(
                dcls, data_fields=data_names, meta_fields=static_names
            )
            return dcls

        if incoming is not None:
            return wrap(incoming)
        return wrap

    @staticmethod
    def static(**kwargs) -> Any:
        """Field specifier marking a dataclass field as static metadata."""
        metadata = dict(kwargs.pop("metadata", {}))
        metadata["pytree_static"] = True
        return dataclasses.field(metadata=metadata, **kwargs)

    @staticmethod
    def field(**kwargs) -> Any:
        """Field specifier for a dynamic (traced) dataclass field."""
        return dataclasses.field(**kwargs)

    # -- Const / Closure conveniences ------------------------------------

    @staticmethod
    def const(v: T) -> "Const[T]":
        """Wrap ``v`` as a static (treedef-resident) value.

        Mirrors reference ``pytree.py:142`` (``Pytree.const``).
        """
        return Const(v)

    @staticmethod
    def tree_const(v: Any) -> Any:
        """Wrap every leaf of ``v`` in :class:`Const`."""
        return jtu.tree_map(Const, v)

    @staticmethod
    def tree_const_unwrap(v: Any) -> Any:
        """Unwrap every :class:`Const` leaf of ``v``."""

        def unwrap(x):
            return x.value if isinstance(x, Const) else x

        return jtu.tree_map(unwrap, v, is_leaf=lambda x: isinstance(x, Const))

    @staticmethod
    def partial(*args) -> Callable[[Callable[..., R]], "Closure[R]"]:
        """Decorator building a :class:`Closure` over dynamic ``args``."""

        def wrap(fn: Callable[..., R]) -> Closure[R]:
            return Closure(args, fn)

        return wrap

    # -- introspection ----------------------------------------------------

    def treedef(self):
        return jtu.tree_structure(self)

    def leaves(self):
        return jtu.tree_leaves(self)

    def replace(self, **updates):
        """Functional field update (dataclasses.replace)."""
        return dataclasses.replace(self, **updates)

    def render_html(self) -> str:
        """HTML rendering (parity: reference ``pytree.py:220-224``)."""
        from genjax_xla.utils.pretty import render_html

        return render_html(self)

    def pformat(self) -> str:
        from genjax_xla.utils.pretty import pformat

        return pformat(self)

    def __repr__(self) -> str:
        if dataclasses.is_dataclass(self):
            parts = []
            for f in dataclasses.fields(self):
                v = getattr(self, f.name)
                if isinstance(v, jnp.ndarray):
                    vs = f"Array({v.shape}, {v.dtype})" if v.ndim else str(v)
                else:
                    vs = repr(v)
                parts.append(f"{f.name}={vs}")
            return f"{type(self).__name__}({', '.join(parts)})"
        return object.__repr__(self)


@Pytree.dataclass
class Const(Pytree, Generic[T]):
    """A static value embedded in a pytree (no leaves; value lives in the
    treedef). JIT-safe carrier for Python values through traced code.

    Parity: reference ``pytree.py:233-295``.
    """

    value: T = Pytree.static()

    def __call__(self, *args, **kwargs):
        return self.value(*args, **kwargs)  # type: ignore[operator]

    def __hash__(self):
        return hash((Const, self.value))

    def __eq__(self, other):
        return isinstance(other, Const) and self.value == other.value

    @staticmethod
    def unwrap(v: Any) -> Any:
        """``Const`` → payload; anything else unchanged."""
        return v.value if isinstance(v, Const) else v


def nth(tree: Any, idx: int) -> Any:
    """Index every leaf of ``tree`` (parity: reference ``pytree.py:337``)."""
    return jtu.tree_map(lambda v: v[idx], tree)


@Pytree.dataclass
class Closure(Pytree, Generic[R]):
    """A closure as a pytree: static code + dynamic closed-over arguments.

    Parity: reference ``pytree.py:299-334``.
    """

    dyn_args: tuple = Pytree.field()
    fn: Callable[..., R] = Pytree.static()

    def __call__(self, *args, **kwargs) -> R:
        return self.fn(*self.dyn_args, *args, **kwargs)


class PythonicPytree(Pytree):
    """Pytree base with pythonic leaf-wise sugar: indexing, iteration,
    concatenation. Parity: reference ``pytree.py:342-376``.
    """

    def __getitem__(self, idx):
        return jtu.tree_map(lambda v: v[idx], self)

    def __len__(self):
        leaves = jtu.tree_leaves(self)
        if not leaves:
            return 0
        return len(leaves[0])

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __add__(self, other):
        return jtu.tree_map(
            lambda a, b: jnp.concatenate([a, b], axis=0), self, other
        )
