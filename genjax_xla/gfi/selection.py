"""``Selection``: a boolean algebra over hierarchical address prefixes — the
filter language for choice maps (which addresses to keep / regenerate /
project).

Parity target: ``Selection`` and its node types in
``/root/reference/src/genjax/_src/core/generative/choice_map.py:78-663``.
"""

from __future__ import annotations

import abc
from typing import Any

import jax.numpy as jnp

from genjax_xla.core.pytree import Pytree
from genjax_xla.core.compiler.staging import FlagOp
from genjax_xla.core.typing import Flag, static_check_is_concrete

__all__ = ["Selection", "addr_tuple"]


def addr_tuple(addr) -> tuple:
    """Normalize an address to a tuple of components."""
    if isinstance(addr, tuple):
        return addr
    return (addr,)


def _is_static_comp(comp) -> bool:
    return isinstance(comp, (str, int)) or comp is Ellipsis


class Selection(Pytree):
    """Abstract selection node.

    Subclasses implement :meth:`check` (is the value at *this* node
    selected?) and :meth:`get_subselection` (descend one address component).
    """

    @abc.abstractmethod
    def check(self) -> Flag: ...

    @abc.abstractmethod
    def get_subselection(self, comp) -> "Selection": ...

    # -- traversal --------------------------------------------------------

    def __call__(self, addr) -> "Selection":
        sel = self
        for comp in addr_tuple(addr):
            sel = sel.get_subselection(comp)
        return sel

    def __getitem__(self, addr) -> Flag:
        return self(addr).check()

    def __contains__(self, addr) -> bool:
        flag = self[addr]
        return bool(jnp.all(jnp.asarray(flag)))

    # -- algebra ----------------------------------------------------------

    def __and__(self, other: "Selection") -> "Selection":
        if isinstance(self, AllSel):
            return other
        if isinstance(other, AllSel):
            return self
        if isinstance(self, NoneSel) or isinstance(other, NoneSel):
            return Selection.none()
        return AndSel(self, other)

    def __or__(self, other: "Selection") -> "Selection":
        if isinstance(self, NoneSel):
            return other
        if isinstance(other, NoneSel):
            return self
        if isinstance(self, AllSel) or isinstance(other, AllSel):
            return Selection.all()
        return OrSel(self, other)

    def __invert__(self) -> "Selection":
        if isinstance(self, AllSel):
            return Selection.none()
        if isinstance(self, NoneSel):
            return Selection.all()
        if isinstance(self, ComplementSel):
            return self.inner
        return ComplementSel(self)

    def complement(self) -> "Selection":
        return ~self

    def mask(self, flag: Flag) -> "Selection":
        """Selection conditioned on a (possibly traced) flag."""
        if FlagOp.concrete_true(flag):
            return self
        if FlagOp.concrete_false(flag):
            return Selection.none()
        return MaskedSel(self, flag)

    def extend(self, *addrs) -> "Selection":
        """Nest this selection under an address prefix.

        Parity: reference ``choice_map.py:298-326``."""
        sel = self
        comps: list = []
        for a in addrs:
            comps.extend(addr_tuple(a))
        for comp in reversed(comps):
            if _is_static_comp(comp):
                sel = StaticSel.build({comp: sel})
            else:
                sel = IdxSel(jnp.asarray(comp), sel)
        return sel

    # -- constructors -----------------------------------------------------

    @staticmethod
    def all() -> "Selection":
        return AllSel()

    @staticmethod
    def none() -> "Selection":
        return NoneSel()

    @staticmethod
    def leaf() -> "Selection":
        return LeafSel()

    @staticmethod
    def idx_above(threshold) -> "Selection":
        """All subtrees at integer addresses > ``threshold`` (traced OK)."""
        return AboveIdxSel(threshold)

    class _AtBuilder:
        def __getitem__(self, addr) -> "Selection":
            return Selection.all().extend(*addr_tuple(addr))

    #: ``Selection.at["x", "y"]`` — select the subtree at ("x", "y").
    at: "Selection._AtBuilder"


Selection.at = Selection._AtBuilder()


@Pytree.dataclass
class AllSel(Selection):
    """Selects everything."""

    def check(self) -> Flag:
        return True

    def get_subselection(self, comp) -> Selection:
        return self


@Pytree.dataclass
class NoneSel(Selection):
    """Selects nothing."""

    def check(self) -> Flag:
        return False

    def get_subselection(self, comp) -> Selection:
        return self


@Pytree.dataclass
class LeafSel(Selection):
    """Selects exactly the value at this node (no descendants)."""

    def check(self) -> Flag:
        return True

    def get_subselection(self, comp) -> Selection:
        return NoneSel()


@Pytree.dataclass
class StaticSel(Selection):
    """Trie node keyed by static address components; ``...`` is a wildcard
    matching any component. Keys are static metadata; subselections are
    dynamic children (they may hold traced flags/indices).

    Parity: reference ``choice_map.py:477-522``."""

    subsels: tuple
    keys: tuple = Pytree.static()

    @staticmethod
    def build(mapping: dict) -> "StaticSel":
        keys = tuple(mapping.keys())
        return StaticSel(tuple(mapping[k] for k in keys), keys)

    def check(self) -> Flag:
        return False

    def get_subselection(self, comp) -> Selection:
        out: Selection = NoneSel()
        if _is_static_comp(comp):
            for key, sub in zip(self.keys, self.subsels):
                if key == comp:
                    out = out | sub
        else:
            # Dynamic component against static int keys: union of masked
            # branch selections.
            for key, sub in zip(self.keys, self.subsels):
                if isinstance(key, int):
                    out = out | sub.mask(jnp.asarray(comp) == key)
        for key, sub in zip(self.keys, self.subsels):
            if key is Ellipsis:
                out = out | sub
        return out


@Pytree.dataclass
class IdxSel(Selection):
    """Dynamic-index selection: selects the subtree at a traced index (or
    array of indices)."""

    idx: Any
    inner: Selection

    def check(self) -> Flag:
        return False

    def get_subselection(self, comp) -> Selection:
        if isinstance(comp, str):
            return NoneSel()
        comp_arr = jnp.asarray(comp)
        idx = jnp.asarray(self.idx)
        # Per-lane membership: preserves comp's shape so array lookups
        # (e.g. filtering an Indexed node lane-wise) get lane-wise flags.
        if idx.ndim == 0:
            hit = comp_arr == idx
        else:
            hit = jnp.any(comp_arr[..., None] == idx, axis=-1)
        if static_check_is_concrete(hit) and hit.ndim == 0:
            return self.inner.mask(bool(hit))
        return self.inner.mask(hit)


@Pytree.dataclass
class AboveIdxSel(Selection):
    """Selects every subtree at integer components strictly greater than a
    (possibly traced) threshold — e.g. the future steps of a Scan trace."""

    threshold: Any

    def check(self) -> Flag:
        return False

    def get_subselection(self, comp) -> Selection:
        if isinstance(comp, str):
            return NoneSel()
        return AllSel().mask(jnp.asarray(comp) > self.threshold)


@Pytree.dataclass
class ComplementSel(Selection):
    inner: Selection

    def check(self) -> Flag:
        return FlagOp.not_(self.inner.check())

    def get_subselection(self, comp) -> Selection:
        return ~self.inner.get_subselection(comp)


@Pytree.dataclass
class AndSel(Selection):
    left: Selection
    right: Selection

    def check(self) -> Flag:
        return FlagOp.and_(self.left.check(), self.right.check())

    def get_subselection(self, comp) -> Selection:
        return self.left.get_subselection(comp) & self.right.get_subselection(comp)


@Pytree.dataclass
class OrSel(Selection):
    left: Selection
    right: Selection

    def check(self) -> Flag:
        return FlagOp.or_(self.left.check(), self.right.check())

    def get_subselection(self, comp) -> Selection:
        return self.left.get_subselection(comp) | self.right.get_subselection(comp)


@Pytree.dataclass
class MaskedSel(Selection):
    inner: Selection
    flag: Flag

    def check(self) -> Flag:
        return FlagOp.and_(self.inner.check(), self.flag)

    def get_subselection(self, comp) -> Selection:
        return self.inner.get_subselection(comp).mask(self.flag)
