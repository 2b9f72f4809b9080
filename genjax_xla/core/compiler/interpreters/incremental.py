"""Incremental computation: a two-point change lattice (``NoChange`` /
``UnknownChange``), ``Diff``-decorated values, and a JVP-style jaxpr
interpreter that propagates change tangents. Powers ``edit``'s weight reuse
and argdiff-aware combinator updates.

Parity:
``/root/reference/src/genjax/_src/core/compiler/interpreters/incremental.py``.
"""

from __future__ import annotations

from typing import Any, Callable

import jax.tree_util as jtu

from genjax_xla.core.pytree import Pytree
from genjax_xla.core.compiler.staging import stage
from genjax_xla.core.compiler.interpreters.environment import Environment
from genjax_xla.core.compiler.interpreters.stateful import (
    StatefulHandler,
    eval_jaxpr_stateful,
)

__all__ = [
    "ChangeTangent",
    "NoChange",
    "UnknownChange",
    "Diff",
    "incremental",
]


class ChangeTangent:
    """A point on the change lattice."""

    def __init__(self, name: str, changed: bool):
        self._name = name
        self.changed = changed

    def __repr__(self):
        return self._name

    def __or__(self, other: "ChangeTangent") -> "ChangeTangent":
        return UnknownChange if (self.changed or other.changed) else NoChange


NoChange = ChangeTangent("NoChange", False)
UnknownChange = ChangeTangent("UnknownChange", True)


@Pytree.dataclass
class Diff(Pytree):
    """A value paired with a change tangent.

    ``Diff`` nodes annotate pytrees at any level; the tree utilities below
    strip or inspect them.
    """

    primal: Any
    tangent: ChangeTangent = Pytree.static()

    # -- constructors -----------------------------------------------------

    @staticmethod
    def no_change(tree: Any) -> Any:
        """Annotate every leaf of ``tree`` as unchanged (existing ``Diff``
        annotations are stripped first, so annotations never nest)."""
        return Diff.tree_diff(Diff.tree_primal(tree), NoChange)

    @staticmethod
    def unknown_change(tree: Any) -> Any:
        """Annotate every leaf of ``tree`` as (possibly) changed."""
        return Diff.tree_diff(Diff.tree_primal(tree), UnknownChange)

    # -- tree utilities ---------------------------------------------------

    @staticmethod
    def tree_primal(tree: Any) -> Any:
        """Strip all ``Diff`` annotations, returning the primal tree."""

        def strip(v):
            return Diff.tree_primal(v.primal) if _is_diff(v) else v

        return jtu.tree_map(strip, tree, is_leaf=_is_diff)

    @staticmethod
    def tree_tangent(tree: Any) -> ChangeTangent:
        """Join all change tangents in ``tree`` (NoChange iff all NoChange).

        Leaves with no ``Diff`` annotation count as UnknownChange, matching
        the conservative default of the reference interpreter.
        """
        tangents: list[ChangeTangent] = []

        def visit(v):
            if _is_diff(v):
                tangents.append(v.tangent)
            else:
                tangents.append(UnknownChange)
            return v

        jtu.tree_map(visit, tree, is_leaf=_is_diff)
        out = NoChange
        for t in tangents:
            out = out | t
        return out

    @staticmethod
    def static_check_no_change(tree: Any) -> bool:
        return not Diff.tree_tangent(tree).changed

    @staticmethod
    def tree_diff(tree: Any, tangent: ChangeTangent) -> Any:
        return jtu.tree_map(
            lambda v: Diff(v, tangent), tree, is_leaf=_is_diff
        )

    def get_primal(self):
        return self.primal

    def get_tangent(self):
        return self.tangent


def _is_diff(x) -> bool:
    return isinstance(x, Diff)


def _default_propagation_rule(primitive, invals: list[Diff], **params):
    """If every input is unchanged, the output is unchanged; otherwise
    recompute on primals and mark outputs UnknownChange."""
    tangent = NoChange
    for v in invals:
        tangent = tangent | v.tangent
    primals = [v.primal for v in invals]
    subfuns, bind_params = primitive.get_bind_params(params)
    outs = primitive.bind(*subfuns, *primals, **bind_params)
    if not primitive.multiple_results:
        outs = [outs]
    return [Diff(o, tangent) for o in outs]


class IncrementalHandler(StatefulHandler):
    """Change-tangent propagation as a stateful-interpreter handler: it
    intercepts every equation, coerces operands to :class:`Diff` duals
    (plain consts become ``NoChange``), and dispatches to the rule table
    (``_default_propagation_rule`` re-executes the primitive and joins
    tangents; site rules — e.g. ``lang/static_edit.py`` — override)."""

    def __init__(self, rules: dict | None = None):
        self.rules = rules or {}

    def handles(self, primitive) -> bool:
        return True

    def dispatch(self, primitive, *invals, **params):
        duals = [
            v if _is_diff(v) else Diff(v, NoChange) for v in invals
        ]
        rule = self.rules.get(primitive, _default_propagation_rule)
        return rule(primitive, duals, **params)


def eval_jaxpr_incremental(
    jaxpr, consts, flat_duals: list[Diff], rules: dict | None = None
) -> list[Diff]:
    """Run a jaxpr under change propagation — built on the generic
    stateful jaxpr interpreter (``interpreters/stateful.py``), which
    supplies the equation walk and environment threading."""
    duals = [
        v if _is_diff(v) else Diff(v, UnknownChange) for v in flat_duals
    ]
    return eval_jaxpr_stateful(
        IncrementalHandler(rules), jaxpr, consts, *duals
    )


def incremental(fn: Callable):
    """``incremental(fn)(primals, tangents)`` — run ``fn`` with change
    propagation. ``tangents`` is a pytree of ``ChangeTangent`` matching the
    (leaf-level) structure of ``primals`` or a single tangent applied to all
    arguments. Returns a ``Diff``-annotated output tree.
    """

    def run(primals: tuple, tangents: Any, **kwargs):
        closed_jaxpr, (_, out_tree, _) = stage(fn)(*primals, **kwargs)
        flat_primals = jtu.tree_leaves(primals)
        if isinstance(tangents, ChangeTangent):
            flat_tangents = [tangents] * len(flat_primals)
        else:
            flat_tangents = jtu.tree_leaves(
                tangents, is_leaf=lambda x: isinstance(x, ChangeTangent)
            )
        duals = [Diff(p, t) for p, t in zip(flat_primals, flat_tangents)]
        flat_out = eval_jaxpr_incremental(
            closed_jaxpr.jaxpr, closed_jaxpr.consts, duals
        )
        return jtu.tree_unflatten(out_tree, flat_out)

    return run
