"""GFI concept vocabulary: weights, scores, argdiffs, and the edit-request
base classes that express SMCP3-style trace moves.

Parity target:
``/root/reference/src/genjax/_src/core/generative/concepts.py``.

Mathematical conventions (documented at reference
``generative_function.py:558-603``): ``edit`` implements an SMCP3 move — it
transforms a trace and returns an *incremental importance weight*

    w = log [ P(new_choices; new_args) · q_bwd ] − log [ P(old_choices;
        old_args) · q_fwd ]

together with the backward request that would invert the move.
"""

from __future__ import annotations

import abc
from typing import TYPE_CHECKING, Any, TypeAlias

import jax

from genjax_xla.core.pytree import Pytree
from genjax_xla.core.compiler.interpreters.incremental import Diff

if TYPE_CHECKING:
    from genjax_xla.gfi.gfn import Trace

__all__ = [
    "Weight",
    "Score",
    "Retval",
    "Arguments",
    "Argdiffs",
    "Retdiff",
    "EditRequest",
    "PrimitiveEditRequest",
    "IndexRequest",
    "NotSupportedEditRequest",
]

#: Log incremental importance weight of an edit / generate move.
Weight: TypeAlias = jax.Array
#: Log density (estimate) of a full trace: log 1/P(choices; args).
Score: TypeAlias = jax.Array
Retval: TypeAlias = Any
Arguments: TypeAlias = tuple
#: Diff-annotated arguments (change hints for incremental edits).
Argdiffs: TypeAlias = tuple
#: Diff-annotated return value.
Retdiff: TypeAlias = Any


class NotSupportedEditRequest(Exception):
    """Raised when a generative function cannot serve an edit request."""


class EditRequest(Pytree):
    """A request to transform a trace (the MCMC/SMC move vocabulary)."""

    @abc.abstractmethod
    def edit(
        self,
        key: jax.Array,
        tr: "Trace",
        argdiffs: Argdiffs,
    ) -> "tuple[Trace, Weight, Retdiff, EditRequest]": ...

    def dimap(self, *, pre, post) -> "EditRequest":
        from genjax_xla.gfi.requests import DiffAnnotate

        return DiffAnnotate(self, pre, post)

    def map(self, post) -> "EditRequest":
        return self.dimap(pre=lambda d: d, post=post)

    def contramap(self, pre) -> "EditRequest":
        return self.dimap(pre=pre, post=lambda d: d)


class PrimitiveEditRequest(EditRequest):
    """An edit request whose semantics are deferred to the generative
    function of the trace: ``tr.get_gen_fn().edit(key, tr, self, argdiffs)``.

    Parity: reference ``concepts.py:135-150``.
    """

    def edit(self, key, tr, argdiffs):
        gen_fn = tr.get_gen_fn()
        return gen_fn.edit(key, tr, self, argdiffs)


@Pytree.dataclass
class IndexRequest(PrimitiveEditRequest):
    """Apply a sub-request at one (possibly traced) index of a vectorized
    generative function (Vmap/Scan lanes).

    Parity: reference ``concepts.py:153-164``.
    """

    idx: Any
    subrequest: EditRequest
