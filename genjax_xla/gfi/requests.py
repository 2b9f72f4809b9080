"""Core edit requests: ``Update`` (constrain to new values), ``Regenerate``
(resample a selection), ``EmptyRequest`` (argdiff-only), ``DiffAnnotate``
(unsafe diff coercion).

Parity targets:
``/root/reference/src/genjax/_src/core/generative/requests.py`` and
``Update`` at ``generative_function.py:1687``.
"""

from __future__ import annotations

from typing import Any, Callable

from genjax_xla.core.pytree import Pytree
from genjax_xla.gfi.choice_map import ChoiceMap
from genjax_xla.gfi.concepts import EditRequest, PrimitiveEditRequest
from genjax_xla.gfi.selection import Selection

__all__ = ["Update", "Regenerate", "EmptyRequest", "DiffAnnotate"]


@Pytree.dataclass
class Update(PrimitiveEditRequest):
    """Constrain a subset of choices to new values; the gen fn reports the
    incremental importance weight and discards the overwritten choices in
    the backward ``Update``."""

    constraint: ChoiceMap


@Pytree.dataclass
class Regenerate(PrimitiveEditRequest):
    """Resample the selected choices from their prior conditionals."""

    selection: Selection = Pytree.field()


@Pytree.dataclass
class EmptyRequest(EditRequest):
    """No constraint change: re-play the trace under (possibly) new args."""

    def edit(self, key, tr, argdiffs):
        gen_fn = tr.get_gen_fn()
        return gen_fn.edit(key, tr, Update(ChoiceMap.empty()), argdiffs)


@Pytree.dataclass
class DiffAnnotate(EditRequest):
    """Coerce argdiffs/retdiff around an inner request. Unsafe: the caller
    asserts the coercion is sound. Parity: reference ``requests.py:69-95``."""

    request: EditRequest
    argdiff_fn: Callable = Pytree.static(default=lambda d: d)
    retdiff_fn: Callable = Pytree.static(default=lambda d: d)

    def edit(self, key, tr, argdiffs):
        new_argdiffs = self.argdiff_fn(argdiffs)
        new_tr, w, retdiff, bwd = self.request.edit(key, tr, new_argdiffs)
        return new_tr, w, self.retdiff_fn(retdiff), bwd
