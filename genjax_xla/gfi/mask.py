"""``Mask``: a value + validity-flag sum type, the framework's vocabulary for
existence uncertainty under vectorization (a lane of a vmapped trace may or
may not contain a choice).

Parity target:
``/root/reference/src/genjax/_src/core/generative/functional_types.py``.
Design difference: flags are ordinary dynamic pytree leaves (possibly traced
bool arrays); all boolean algebra goes through ``FlagOp`` so statically-known
flags fold away at trace time.
"""

from __future__ import annotations

from typing import Any, Generic, TypeVar

import jax.numpy as jnp
import jax.tree_util as jtu
from jax.experimental import checkify

from genjax_xla.core.checks import optional_check
from genjax_xla.core.pytree import Pytree
from genjax_xla.core.compiler.staging import FlagOp, tree_choose
from genjax_xla.core.typing import Flag

T = TypeVar("T")

__all__ = ["Mask"]


@Pytree.dataclass
class Mask(Pytree, Generic[T]):
    """A value whose existence is conditioned on ``flag``.

    ``flag`` may be a concrete Python bool (statically known) or a traced
    bool array broadcastable against the batch dimensions of ``value``.
    """

    value: T
    flag: Flag

    # -- constructors -----------------------------------------------------

    @staticmethod
    def _align(f1: Flag, f2: Flag) -> tuple[Flag, Flag]:
        """Leading-dim (lane-first) alignment of two flags: the
        lower-rank flag gains trailing singleton axes, so a per-lane
        flag combines with a deeper (lane, batch, …)-shaped one (numpy
        broadcasting alone aligns TRAILING dims, which is wrong for
        lane-leading flag layouts)."""
        if isinstance(f1, bool) or isinstance(f2, bool):
            return f1, f2
        n1, n2 = jnp.ndim(f1), jnp.ndim(f2)
        if n1 < n2:
            f1 = jnp.reshape(jnp.asarray(f1),
                             jnp.shape(f1) + (1,) * (n2 - n1))
        elif n2 < n1:
            f2 = jnp.reshape(jnp.asarray(f2),
                             jnp.shape(f2) + (1,) * (n1 - n2))
        return f1, f2

    @staticmethod
    def build(v: "T | Mask[T]", f: Flag = True) -> "Mask[T]":
        """Build a mask, AND-combining with an existing mask's flag.

        Parity: reference ``functional_types.py:144-169``.
        """
        if isinstance(v, Mask):
            f1, f2 = Mask._align(v.flag, f)
            return Mask(v.value, FlagOp.and_(f1, f2))
        return Mask(v, f)

    @staticmethod
    def maybe_mask(v: "T | Mask[T] | None", f: Flag) -> "T | Mask[T] | None":
        """Like :meth:`build`, but concretely-known flags simplify: True
        yields the raw value, False yields ``None``.

        Parity: reference ``functional_types.py:171-191``.
        """
        if v is None:
            return None
        m = Mask.build(v, f)
        if FlagOp.concrete_true(m.flag):
            return m.value
        if FlagOp.concrete_false(m.flag):
            return None
        return m

    @staticmethod
    def maybe(v: "T | Mask[T] | None") -> "Mask[T]":
        """Normalize a possibly-absent, possibly-masked value to a Mask."""
        if v is None:
            return Mask(jnp.zeros(()), False)
        return Mask.build(v, True)

    # -- access -----------------------------------------------------------

    def unmask(self, default: T | None = None) -> T:
        """Extract the value. With no ``default``, validity is asserted via
        an (opt-in) checkify check; with a ``default``, invalid lanes are
        replaced elementwise. Parity: reference ``functional_types.py:233-260``.
        """
        if default is None:

            def check():
                checkify.check(
                    jnp.all(jnp.asarray(self.flag)),
                    "Attempted to unmask a Mask with flag False.",
                )

            optional_check(check)
            return self.value

        def select(v, d):
            v = jnp.asarray(v)
            flag = jnp.broadcast_to(
                jnp.reshape(
                    jnp.asarray(self.flag),
                    jnp.shape(self.flag) + (1,) * (v.ndim - jnp.ndim(self.flag)),
                ),
                v.shape,
            )
            return jnp.where(flag, v, d)

        return jtu.tree_map(select, self.value, default)

    def primal_flag(self) -> Flag:
        return self.flag

    def flatten(self) -> "Mask[T]":
        """Collapse nested masks: ``Mask(Mask(v, f1), f2)`` →
        ``Mask(v, f1 & f2)``. Parity: reference
        ``functional_types.py:211-231``."""
        if isinstance(self.value, Mask):
            return Mask.build(self.value, self.flag).flatten()
        return self

    def __getitem__(self, idx) -> "Mask[T]":
        """Index into batch dimensions of both value and flag."""
        new_value = jtu.tree_map(lambda v: v[idx], self.value)
        flag = self.flag
        if not isinstance(flag, bool) and jnp.ndim(flag) > 0:
            flag = flag[idx]
        return Mask(new_value, flag)

    # -- algebra ----------------------------------------------------------

    @staticmethod
    def _broadcast_values(a, b):
        """Leafwise broadcast so lane-flagged combinations of scalar and
        per-lane values stack cleanly."""

        def bc(x, y):
            x, y = jnp.asarray(x), jnp.asarray(y)
            shp = jnp.broadcast_shapes(x.shape, y.shape)
            return jnp.broadcast_to(x, shp), jnp.broadcast_to(y, shp)

        pairs = jtu.tree_map(bc, a, b)
        return (
            jtu.tree_map(lambda p: p[0], pairs,
                         is_leaf=lambda p: isinstance(p, tuple)),
            jtu.tree_map(lambda p: p[1], pairs,
                         is_leaf=lambda p: isinstance(p, tuple)),
        )

    @staticmethod
    def _select_by_flag(flag: Flag, va, vb):
        """Leafwise ``where(flag, va, vb)``; a per-lane flag broadcasts
        over trailing event dims (``tree_choose`` is scalar-index only —
        a vector index there becomes an outer-product gather)."""
        if isinstance(flag, bool):
            return va if flag else vb
        f = jnp.asarray(flag)
        if f.ndim == 0:
            return tree_choose(jnp.where(f, 0, 1), [va, vb])

        def pick(x, y):
            ff = f.reshape(f.shape + (1,) * (jnp.ndim(x) - f.ndim))
            return jnp.where(ff, x, y)

        return jtu.tree_map(pick, va, vb)

    def __or__(self, other: "Mask[T]") -> "Mask[T]":
        """Disjunction: valid if either is; prefers ``self``'s value when
        both valid. Parity: reference ``functional_types.py:283-315``."""
        assert isinstance(other, Mask)
        new_flag = FlagOp.or_(self.flag, other.flag)
        va, vb = Mask._broadcast_values(self.value, other.value)
        value = Mask._select_by_flag(self.flag, va, vb)
        return Mask(value, new_flag)

    def __xor__(self, other: "Mask[T]") -> "Mask[T]":
        """Exclusive disjunction: valid iff exactly one is.

        Parity: reference ``functional_types.py:316-338``."""
        assert isinstance(other, Mask)
        new_flag = FlagOp.xor_(self.flag, other.flag)
        va, vb = Mask._broadcast_values(self.value, other.value)
        value = Mask._select_by_flag(self.flag, va, vb)
        return Mask(value, new_flag)

    @staticmethod
    def or_n(*masks: "Mask[T]") -> "Mask[T]":
        out = masks[0]
        for m in masks[1:]:
            out = out | m
        return out

    @staticmethod
    def xor_n(*masks: "Mask[T]") -> "Mask[T]":
        out = masks[0]
        for m in masks[1:]:
            out = out ^ m
        return out
