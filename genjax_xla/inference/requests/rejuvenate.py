"""``Rejuvenate``: MH-with-custom-proposal (sans accept step) as an SMCP3
move — propose, Update-edit, assess the backward proposal; the edit weight
is ``w_update + bwd_proposal_score − fwd_proposal_score``.

Parity target:
``/root/reference/src/genjax/_src/inference/requests/rejuvenate.py:44-94``.
"""

from __future__ import annotations

from typing import Any

import jax

from genjax_xla.core.pytree import Pytree
from genjax_xla.core.compiler.interpreters.incremental import Diff
from genjax_xla.gfi.concepts import Argdiffs, EditRequest
from genjax_xla.gfi.gfn import GenerativeFunction, Trace
from genjax_xla.gfi.requests import Update

__all__ = ["Rejuvenate"]


@Pytree.dataclass
class Rejuvenate(EditRequest):
    """``proposal``: a gen fn taking ``(old_choices, *proposal_args)`` whose
    choices address a subset of the model's; the backward proposal is the
    same family evaluated at the discarded choices."""

    proposal: GenerativeFunction[Any]
    proposal_args: tuple = Pytree.field(default=())

    def edit(self, key: jax.Array, tr: Trace[Any], argdiffs: Argdiffs):
        key, sub_key = jax.random.split(key)
        old_choices = tr.get_choices()
        fwd_tr = self.proposal.simulate(
            sub_key, (old_choices, *self.proposal_args)
        )
        fwd_score = fwd_tr.get_score()
        proposed = fwd_tr.get_choices()

        new_tr, w, retdiff, bwd = Update(proposed).edit(key, tr, argdiffs)
        assert isinstance(bwd, Update)
        discarded = bwd.constraint

        bwd_score, _ = self.proposal.assess(
            discarded, (new_tr.get_choices(), *self.proposal_args)
        )
        final_w = w + bwd_score - fwd_score
        return new_tr, final_w, retdiff, Rejuvenate(self.proposal,
                                                    self.proposal_args)
