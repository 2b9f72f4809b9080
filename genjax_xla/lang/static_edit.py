"""Fine-grained incremental edits for ``@gen`` functions.

The coarse handler rule in ``lang/static.py`` marks *every* site after the
first change as ``unknown_change``, so an MH sweep over an S-site chain
model re-scores O(S²) sites. This module recovers the reference's
fine-grained behavior (``/root/reference/src/genjax/_src/generative_functions/
static.py:443-466`` threading per-value change tangents through the body
jaxpr via ``incremental.py:316-346``) inside the handler architecture:

1. The body is staged once with a :class:`StagingHandler` that records each
   traced site as one equation of the initial-style ``site_p`` primitive
   (operands: the flattened ``(gen_fn, args)``; outputs: the old subtrace's
   retval structure).
2. The staged jaxpr runs under the existing incremental (Diff) interpreter
   (``core/compiler/interpreters/incremental.py``) with a custom ``site_p``
   rule that performs the per-site sub-edit with *exact* per-leaf argdiffs
   — a site is re-scored only if a value actually feeding it changed.

Randomness is bitwise-identical to the coarse path: per-site keys are
``fold_in(key, counter)`` in the same visitation order. Bodies whose
control flow needs concrete values can't be staged; ``Fn.edit`` falls back
to the coarse handler path for those.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
import jax.tree_util as jtu

from genjax_xla.core.compiler.initial_style_primitive import (
    InitialStylePrimitive,
    initial_style_bind,
)
from genjax_xla.core.compiler.interpreters.incremental import (
    Diff,
    NoChange,
    UnknownChange,
    eval_jaxpr_incremental,
)
from genjax_xla.core.compiler.staging import stage
from genjax_xla.gfi.choice_map import ChoiceMap
from genjax_xla.gfi.requests import Regenerate, Update

__all__ = ["edit_via_incremental", "site_p"]

site_p = InitialStylePrimitive("genjax_site")


class StagingHandler:
    """Handler that *stages* the body: each traced call becomes one
    ``site_p`` equation instead of being executed. Address validation
    is shared with the coarse-path handlers
    (``static.validate_new_address``) so the two edit paths cannot
    diverge."""

    def __init__(self, previous):
        self.previous = previous
        self.addresses: list = []

    def visit(self, addr):
        from genjax_xla.lang.static import validate_new_address

        validate_new_address(self.addresses, addr)
        self.addresses.append(addr)

    def handle(self, addr, gen_fn, args):
        self.visit(addr)
        old_retval = self.previous.get_inner_trace(addr).get_retval()

        def placeholder(_gen_fn, _args):
            # Abstract-eval stand-in: the edited site's retval has the old
            # retval's structure (static DSL bodies have static structure).
            return old_retval

        return initial_style_bind(site_p, addr=addr)(placeholder)(
            gen_fn, args
        )

    def __enter__(self):
        from genjax_xla.lang.static import _HANDLER_STACK

        _HANDLER_STACK.append(self)
        return self

    def __exit__(self, *exc):
        from genjax_xla.lang.static import _HANDLER_STACK

        popped = _HANDLER_STACK.pop()
        assert popped is self
        return False


class _EditCtx:
    """Mutable accumulator threaded through the site rule (program order =
    jaxpr equation order = handler visitation order)."""

    def __init__(self, key, previous, request):
        self.key = key
        self.previous = previous
        self.request = request
        self.counter = 0
        self.weight = jnp.zeros(())
        self.addresses: list = []
        self.subtraces: list = []
        self.discard: list = []
        self.bwd: dict = {}

    def sub_request(self, addr):
        if isinstance(self.request, Update):
            return Update(self.request.constraint.get_submap(addr))
        if isinstance(self.request, Regenerate):
            return Regenerate(self.request.selection(addr))
        # StaticRequest
        return self.request.addressed.get(addr, Update(ChoiceMap.empty()))


def _flat_leaf_tangents(argdiffs, n_leaves: int):
    """Per-primal-leaf change tangents from a (possibly partially)
    Diff-annotated args tree."""
    tangents: list = []

    def visit(v):
        if isinstance(v, Diff):
            k = len(jtu.tree_leaves(Diff.tree_primal(v.primal)))
            tangents.extend([v.tangent] * k)
        else:
            tangents.append(UnknownChange)
        return v

    jtu.tree_map(visit, argdiffs, is_leaf=lambda x: isinstance(x, Diff))
    assert len(tangents) == n_leaves, (len(tangents), n_leaves)
    return tangents


def _make_site_rule(ctx: _EditCtx):
    def rule(_primitive, invals, *, addr, in_tree, num_consts, **_params):
        arg_duals = invals[num_consts:]
        primals = [d.primal for d in arg_duals]
        gen_fn, site_args = jtu.tree_unflatten(in_tree, primals)
        duals_tree = jtu.tree_unflatten(in_tree, arg_duals)
        gen_fn_duals, site_arg_duals = duals_tree

        # If the gen fn's own dynamic leaves changed (e.g. a Closure over
        # a changed value), conservatively mark all site args changed.
        gf_changed = any(
            d.tangent.changed for d in jtu.tree_leaves(
                gen_fn_duals, is_leaf=lambda x: isinstance(x, Diff)
            ) if isinstance(d, Diff)
        )
        argdiffs = (
            Diff.unknown_change(site_args) if gf_changed
            else site_arg_duals
        )

        sub_key = jax.random.fold_in(ctx.key, ctx.counter)
        ctx.counter += 1
        old_sub = ctx.previous.get_inner_trace(addr)
        sub_req = ctx.sub_request(addr)
        if isinstance(sub_req, (Update, Regenerate)):
            new_sub, w, retdiff, bwd = gen_fn.edit(
                sub_key, old_sub, sub_req, argdiffs
            )
        else:
            new_sub, w, retdiff, bwd = sub_req.edit(
                sub_key, old_sub, argdiffs
            )

        ctx.weight = ctx.weight + w
        ctx.addresses.append(addr)
        ctx.subtraces.append(new_sub)
        if isinstance(bwd, Update) and not bwd.constraint.static_is_empty():
            ctx.discard.append((addr, bwd.constraint))
        ctx.bwd[addr] = bwd

        primal_ret = Diff.tree_primal(retdiff)
        tangent = Diff.tree_tangent(retdiff)
        return [Diff(v, tangent) for v in jtu.tree_leaves(primal_ret)]

    return rule


def edit_via_incremental(fn, key, trace, request, argdiffs):
    """Fine-grained edit of a ``@gen`` trace. Returns the same
    ``(new_trace, weight, retdiff, ctx)`` ingredients as the coarse
    handlers, with ``ctx`` carrying discard/bwd accumulators.

    Raises whatever staging raises for bodies that need concrete control
    flow — the caller falls back to the coarse path.
    """
    from genjax_xla.lang.static import StaticTrace

    args = Diff.tree_primal(argdiffs)

    with StagingHandler(trace) as sh:
        closed_jaxpr, (_, out_tree, _) = stage(fn.source)(*args)

    flat_primals = jtu.tree_leaves(args)
    tangents = _flat_leaf_tangents(argdiffs, len(flat_primals))
    duals = [Diff(p, t) for p, t in zip(flat_primals, tangents)]

    ctx = _EditCtx(key, trace, request)
    flat_out = eval_jaxpr_incremental(
        closed_jaxpr.jaxpr,
        closed_jaxpr.consts,
        duals,
        rules={site_p: _make_site_rule(ctx)},
    )
    # Literal/constvar outputs come back as raw values (the interpreter
    # only wraps eqn outputs) — coerce them to NoChange Diffs so bodies
    # returning constants or closed-over arrays stay editable.
    flat_out = [
        d if isinstance(d, Diff) else Diff(d, NoChange)
        for d in flat_out
    ]
    retval = jtu.tree_unflatten(out_tree, [d.primal for d in flat_out])
    out_tangent = NoChange
    for d in flat_out:
        out_tangent = out_tangent | d.tangent
    retdiff = Diff.tree_diff(retval, out_tangent)

    new_trace = StaticTrace(
        fn, args, retval, tuple(ctx.subtraces), tuple(ctx.addresses)
    )
    return new_trace, ctx.weight, retdiff, ctx
