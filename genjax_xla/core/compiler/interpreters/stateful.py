"""Stateful jaxpr interpreter: walks a staged jaxpr equation-by-equation and
dispatches chosen primitives to a side-effecting handler. This is the generic
effect-handler backbone; the `@gen` DSL itself uses Python-trace-time handlers
(see ``genjax_xla.lang.static``), but this interpreter powers jaxpr-level
tooling (dependence analysis, debugger, custom transforms).

Parity:
``/root/reference/src/genjax/_src/core/compiler/interpreters/stateful.py``.
"""

from __future__ import annotations

import abc
from typing import Any, Callable

import jax.tree_util as jtu

from genjax_xla.core.compiler.staging import stage
from genjax_xla.core.compiler.interpreters.environment import Environment

__all__ = ["StatefulHandler", "eval_jaxpr_stateful", "stateful"]


class StatefulHandler(abc.ABC):
    """Handler deciding which primitives it intercepts and how."""

    @abc.abstractmethod
    def handles(self, primitive) -> bool: ...

    @abc.abstractmethod
    def dispatch(self, primitive, *args, **params) -> list[Any]: ...


def eval_jaxpr_stateful(handler: StatefulHandler, jaxpr, consts, *flat_args):
    env = Environment()
    for var, val in zip(jaxpr.constvars, consts):
        env[var] = val
    for var, val in zip(jaxpr.invars, flat_args):
        env[var] = val

    for eqn in jaxpr.eqns:
        invals = [env[v] for v in eqn.invars]
        if handler.handles(eqn.primitive):
            outs = handler.dispatch(eqn.primitive, *invals, **eqn.params)
        else:
            subfuns, bind_params = eqn.primitive.get_bind_params(eqn.params)
            outs = eqn.primitive.bind(*subfuns, *invals, **bind_params)
            if not eqn.primitive.multiple_results:
                outs = [outs]
        for var, val in zip(eqn.outvars, outs):
            env[var] = val

    return [env[v] for v in jaxpr.outvars]


def stateful(fn: Callable):
    """``stateful(fn)(handler, *args)`` — run ``fn`` under ``handler``."""

    def run(handler: StatefulHandler, *args, **kwargs):
        closed_jaxpr, (_, out_tree, _) = stage(fn)(*args, **kwargs)
        flat_args = jtu.tree_leaves(args)
        flat_out = eval_jaxpr_stateful(
            handler, closed_jaxpr.jaxpr, closed_jaxpr.consts, *flat_args
        )
        return jtu.tree_unflatten(out_tree, flat_out)

    return run
