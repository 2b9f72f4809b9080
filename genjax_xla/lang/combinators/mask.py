"""``MaskCombinator``: existence uncertainty for a whole generative-function
invocation — an extra leading bool argument gates the score, and the return
value is wrapped in :class:`Mask`.

Parity target: ``/root/reference/src/genjax/_src/generative_functions/
combinators/mask.py`` (``MaskTrace.build`` :62-89, ``MaskCombinator`` :110,
4-case edit weight table :214-253, ``mask`` decorator :285).
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
import jax.tree_util as jtu

from genjax_xla.core.pytree import Pytree
from genjax_xla.core.compiler.staging import FlagOp
from genjax_xla.core.compiler.interpreters.incremental import Diff
from genjax_xla.core.typing import Flag
from genjax_xla.gfi.choice_map import ChoiceMap
from genjax_xla.gfi.concepts import Argdiffs, EditRequest, Score, Weight
from genjax_xla.gfi.gfn import GenerativeFunction, Trace
from genjax_xla.gfi.mask import Mask
from genjax_xla.gfi.requests import Update
from genjax_xla.gfi.selection import Selection

__all__ = ["MaskCombinator", "MaskTrace", "mask"]


def _flag_times(flag: Flag, x):
    if flag is True:
        return x
    if flag is False:
        return jnp.zeros_like(x)
    return jnp.asarray(flag, x.dtype if hasattr(x, "dtype") else None) * x


@Pytree.dataclass
class MaskTrace(Trace[Any]):
    """Inner trace + gate flag; score is gated. Parity: reference
    ``mask.py:62-108``."""

    gen_fn: "MaskCombinator"
    inner: Trace
    check: Flag

    def get_args(self) -> tuple:
        return (self.check, *self.inner.get_args())

    def get_retval(self):
        return Mask.build(self.inner.get_retval(), self.check)

    def get_gen_fn(self):
        return self.gen_fn

    def get_score(self) -> Score:
        return _flag_times(self.check, self.inner.get_score())

    def get_choices(self) -> ChoiceMap:
        return self.inner.get_choices().mask(self.check)

    def get_inner_trace(self, address):
        return self.inner.get_inner_trace(address)


def _check_scalar_flag(check):
    """A vector flag would silently produce a VECTOR score — a GFI
    contract violation. Vectorize with ``.vmap()`` around the masked
    fn instead (parity: reference ``mask.py`` flag validation,
    ``tests/.../test_mask_fails_with_vector_mask``). Traced scalars
    (including under vmap batching, where the tracer's aval is
    scalar) pass."""
    if jnp.ndim(check) != 0:
        raise TypeError(
            "mask flag must be a scalar (got shape "
            f"{jnp.shape(check)}); vmap the masked function instead"
        )
    return check


@Pytree.dataclass
class MaskCombinator(GenerativeFunction[Any]):
    """Args: ``(flag, *inner_args)``; retval ``Mask(inner_ret, flag)``."""

    inner: GenerativeFunction[Any]

    def simulate(self, key: jax.Array, args: tuple) -> MaskTrace:
        check, inner_args = _check_scalar_flag(args[0]), args[1:]
        tr = self.inner.simulate(key, inner_args)
        return MaskTrace(self, tr, check)

    def assess(self, chm: ChoiceMap, args: tuple):
        check, inner_args = _check_scalar_flag(args[0]), args[1:]
        if isinstance(check, (bool, int)) and not check:
            # Statically masked OFF: a simulated trace's choices prune
            # to Empty under a concrete False flag (ChoiceMap.mask),
            # so the simulate→assess round trip must not demand inner
            # values — nothing was measured, the score is 0 and the
            # retval a zero-filled shape evaluation (round-5
            # combinator-fuzz fix; traced flags keep Mask-wrapped
            # values and take the general path below).
            from genjax_xla.core.compiler.staging import empty_trace

            zero = empty_trace(self.inner, inner_args)
            return jnp.zeros(()), Mask.build(zero.get_retval(), check)
        score, retval = self.inner.assess(chm, inner_args)
        return _flag_times(check, score), Mask.build(retval, check)

    def generate(self, key: jax.Array, constraint: ChoiceMap, args: tuple):
        check, inner_args = _check_scalar_flag(args[0]), args[1:]
        tr, w = self.inner.generate(key, constraint, inner_args)
        return MaskTrace(self, tr, check), _flag_times(check, w)

    def project(self, key: jax.Array, trace: MaskTrace,
                selection: Selection) -> Weight:
        w = self.inner.project(key, trace.inner, selection)
        return _flag_times(trace.check, w)

    def edit(self, key: jax.Array, trace: MaskTrace, request: EditRequest,
             argdiffs: Argdiffs):
        """Edit with the 4-case (pre-flag × post-flag) weight table:
        T→T: inner edit weight; T→F: −old score (choices removed);
        F→T: +new score (masked sampling process reused as the proposal);
        F→F: 0. Parity: reference ``mask.py:186-253``."""
        check_diff, inner_argdiffs = argdiffs[0], argdiffs[1:]
        post_check = Diff.tree_primal(check_diff)
        pre_check = trace.check

        new_inner, w, inner_retdiff, bwd = request.edit(
            key, trace.inner, inner_argdiffs
        )

        t_to_t = FlagOp.and_(pre_check, post_check)
        t_to_f = FlagOp.and_(pre_check, FlagOp.not_(post_check))
        f_to_t = FlagOp.and_(FlagOp.not_(pre_check), post_check)

        final_weight = (
            _flag_times(t_to_t, w)
            + _flag_times(t_to_f, -trace.inner.get_score())
            + _flag_times(f_to_t, new_inner.get_score())
        )

        new_trace = MaskTrace(self, new_inner, post_check)
        retdiff = Mask.build(inner_retdiff, check_diff)
        if isinstance(bwd, Update):
            bwd = Update(bwd.constraint.mask(post_check))
        return new_trace, final_weight, retdiff, bwd


def mask(gen_fn: GenerativeFunction) -> MaskCombinator:
    """Parity: reference ``mask.py:285-322``."""
    return MaskCombinator(gen_fn)
