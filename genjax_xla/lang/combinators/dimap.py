"""``Dimap`` combinator: profunctor pre/post transformation of arguments and
return value. ``edit`` pushes argdiffs through the incremental (Diff)
interpreter so change information survives the argument mapping.

Parity target: ``/root/reference/src/genjax/_src/generative_functions/
combinators/dimap.py`` (``DimapTrace`` :45, ``Dimap`` :71, incremental
argdiff push :148-193, ``dimap``/``map``/``contramap`` :220-359).
"""

from __future__ import annotations

from typing import Any, Callable

import jax

from genjax_xla.core.pytree import Pytree
from genjax_xla.core.compiler.interpreters.incremental import Diff, incremental
from genjax_xla.gfi.choice_map import ChoiceMap
from genjax_xla.gfi.concepts import Argdiffs, EditRequest, Score, Weight
from genjax_xla.gfi.gfn import GenerativeFunction, Trace
from genjax_xla.gfi.selection import Selection

__all__ = ["Dimap", "DimapTrace", "dimap", "map_retval", "contramap"]


@Pytree.dataclass
class DimapTrace(Trace[Any]):
    """Parity: reference ``dimap.py:45-69``."""

    gen_fn: "Dimap"
    inner: Trace
    args: tuple
    retval: Any

    def get_args(self) -> tuple:
        return self.args

    def get_retval(self):
        return self.retval

    def get_gen_fn(self):
        return self.gen_fn

    def get_score(self) -> Score:
        return self.inner.get_score()

    def get_choices(self) -> ChoiceMap:
        return self.inner.get_choices()

    def get_inner_trace(self, address):
        return self.inner.get_inner_trace(address)


@Pytree.dataclass
class Dimap(GenerativeFunction[Any]):
    """``pre: *args -> inner_args`` (tuple), ``post: (args, inner_ret) ->
    ret``."""

    inner: GenerativeFunction[Any]
    pre: Callable = Pytree.static(default=lambda *args: args)
    post: Callable = Pytree.static(default=lambda args, ret: ret)

    def _pre(self, args):
        inner_args = self.pre(*args)
        assert isinstance(inner_args, tuple), (
            "Dimap pre must return an argument tuple"
        )
        return inner_args

    def simulate(self, key: jax.Array, args: tuple) -> DimapTrace:
        inner_tr = self.inner.simulate(key, self._pre(args))
        retval = self.post(args, inner_tr.get_retval())
        return DimapTrace(self, inner_tr, args, retval)

    def assess(self, chm: ChoiceMap, args: tuple):
        score, inner_ret = self.inner.assess(chm, self._pre(args))
        return score, self.post(args, inner_ret)

    def generate(self, key: jax.Array, constraint: ChoiceMap, args: tuple):
        inner_tr, w = self.inner.generate(key, constraint, self._pre(args))
        retval = self.post(args, inner_tr.get_retval())
        return DimapTrace(self, inner_tr, args, retval), w

    def project(self, key: jax.Array, trace: DimapTrace,
                selection: Selection) -> Weight:
        return self.inner.project(key, trace.inner, selection)

    def edit(self, key: jax.Array, trace: DimapTrace, request: EditRequest,
             argdiffs: Argdiffs):
        args = Diff.tree_primal(argdiffs)
        # Push argdiffs through `pre` with the incremental interpreter so
        # NoChange survives deterministic argument plumbing.
        tangent = Diff.tree_tangent(argdiffs)
        inner_argdiffs = incremental(self.pre)(tuple(args), tangent)
        assert isinstance(Diff.tree_primal(inner_argdiffs), tuple)
        new_inner, w, inner_retdiff, bwd = request.edit(
            key, trace.inner, inner_argdiffs
        )
        retval = self.post(args, new_inner.get_retval())
        new_trace = DimapTrace(self, new_inner, args, retval)
        out_tangent = Diff.tree_tangent(inner_retdiff) | tangent
        retdiff = Diff.tree_diff(retval, out_tangent)
        return new_trace, w, retdiff, bwd


def dimap(*, pre=None, post=None) -> Callable:
    def decorator(gen_fn: GenerativeFunction) -> Dimap:
        return Dimap(
            gen_fn,
            pre if pre is not None else (lambda *args: args),
            post if post is not None else (lambda args, ret: ret),
        )

    return decorator


def map_retval(post: Callable) -> Callable:
    def decorator(gen_fn: GenerativeFunction) -> Dimap:
        return Dimap(gen_fn, post=lambda args, ret: post(ret))

    return decorator


def contramap(pre: Callable) -> Callable:
    def decorator(gen_fn: GenerativeFunction) -> Dimap:
        return Dimap(gen_fn, pre=pre)

    return decorator
