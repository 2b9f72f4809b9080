"""``Scan`` combinator: Markov composition ``(c, a) -> (c, b)`` of a
generative function over ``jax.lax.scan`` — the sequence axis stays
on-device and sequential (one compiled step body, static
shapes), while particle/chain axes shard across the mesh (SURVEY §2.3).

Parity target: ``/root/reference/src/genjax/_src/generative_functions/
combinators/scan.py`` (``ScanTrace`` :55, ``Scan`` :109, per-step fold_in
keys :213, int-indexed choices :77, ``assess`` :638-664, derived
``accumulate``/``reduce``/``iterate``/``iterate_final``/``masked_iterate``
:791-1150). ``IndexRequest`` edits dispatch to ``_edit_index_fast`` — an
O(1) single-step repair valid when the scanned args are unchanged (parity
with the reference's ``edit_index`` carry-repair, its ``scan.py:325-416``)
— and fall back to a full re-scan under changed args (correct for all
argdiffs).
"""

from __future__ import annotations

from typing import Any, Callable

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
from jax import lax

from genjax_xla.core.pytree import Pytree
from genjax_xla.core.compiler.interpreters.incremental import (
    Diff,
    NoChange,
    UnknownChange,
)
from genjax_xla.gfi.choice_map import ChoiceMap, Indexed
from genjax_xla.gfi.concepts import (
    Argdiffs,
    EditRequest,
    IndexRequest,
    Score,
    Weight,
)
from genjax_xla.gfi.gfn import GenerativeFunction, Trace
from genjax_xla.gfi.mask import Mask
from genjax_xla.gfi.requests import Regenerate, Update
from genjax_xla.gfi.selection import Selection

__all__ = [
    "Scan",
    "ScanTrace",
    "scan",
    "accumulate",
    "reduce",
    "iterate",
    "iterate_final",
    "masked_iterate",
    "masked_iterate_final",
    "prepend_initial_acc",
]


@Pytree.dataclass
class ScanTrace(Trace[Any]):
    """Stacked per-step inner traces (axis 0 = time); score is the sum of
    step scores. Parity: reference ``scan.py:55-97``."""

    gen_fn: "Scan"
    inner: Trace
    args: tuple
    retval: Any
    n: int = Pytree.static()

    def get_args(self) -> tuple:
        return self.args

    def get_retval(self):
        return self.retval

    def get_gen_fn(self):
        return self.gen_fn

    def get_score(self) -> Score:
        return jnp.sum(self.inner.get_score())

    def get_choices(self) -> ChoiceMap:
        return Indexed(self.inner.get_choices(), None, self.n)

    def get_inner_trace(self, address):
        if isinstance(address, str):
            # Named-site lookup: delegate structurally to the batched
            # inner trace — the result is the site's subtrace with the
            # lane/step axis leading (parity: reference
            # ``test_get_subtrace_vmap`` / ``test_get_subtrace_scan``:
            # per-lane scores sum to the total score).
            return self.inner.get_inner_trace(address)
        return jtu.tree_map(lambda v: v[address], self.inner)


@Pytree.dataclass
class Scan(GenerativeFunction[Any]):
    """``Scan(inner, length)``: ``inner`` has signature
    ``(carry, scanned_in) -> (carry, out)``; the scanned gen fn has
    signature ``(init_carry, scanned_ins) -> (final_carry, stacked_outs)``.
    Choices live under integer step addresses."""

    inner: GenerativeFunction[Any]
    length: int | None = Pytree.static(default=None)

    def _n(self, args) -> int:
        if self.length is not None:
            return self.length
        _, xs = args
        leaves = jtu.tree_leaves(xs)
        if not leaves:
            raise ValueError("Scan without length requires scanned inputs.")
        return jnp.shape(leaves[0])[0]

    def simulate(self, key: jax.Array, args: tuple) -> ScanTrace:
        init, xs = args
        n = self._n(args)

        def step(carry, inp):
            i, x = inp
            sub_key = jax.random.fold_in(key, i)
            tr = self.inner.simulate(sub_key, (carry, x))
            new_carry, out = tr.get_retval()
            return new_carry, (tr, out)

        final, (inner_tr, outs) = lax.scan(
            step, init, (jnp.arange(n), xs), length=n
        )
        return ScanTrace(self, inner_tr, args, (final, outs), n)

    def assess(self, chm: ChoiceMap, args: tuple):
        init, xs = args
        n = self._n(args)

        def step(carry, inp):
            i, x = inp
            sub = chm.get_submap(i)
            score, (new_carry, out) = self.inner.assess(sub, (carry, x))
            return new_carry, (score, out)

        final, (scores, outs) = lax.scan(
            step, init, (jnp.arange(n), xs), length=n
        )
        return jnp.sum(scores), (final, outs)

    def generate(self, key: jax.Array, constraint: ChoiceMap, args: tuple):
        init, xs = args
        n = self._n(args)

        def step(carry, inp):
            i, x = inp
            sub_key = jax.random.fold_in(key, i)
            sub = constraint.get_submap(i)
            tr, w = self.inner.generate(sub_key, sub, (carry, x))
            new_carry, out = tr.get_retval()
            return new_carry, (tr, w, out)

        final, (inner_tr, ws, outs) = lax.scan(
            step, init, (jnp.arange(n), xs), length=n
        )
        trace = ScanTrace(self, inner_tr, args, (final, outs), n)
        return trace, jnp.sum(ws)

    def project(self, key: jax.Array, trace: ScanTrace,
                selection: Selection) -> Weight:
        n = trace.n

        def step(_, inp):
            i, inner_tr = inp
            sub_key = jax.random.fold_in(key, i)
            subsel = selection(i)
            w = self.inner.project(sub_key, inner_tr, subsel)
            return None, w

        _, ws = lax.scan(step, None, (jnp.arange(n), trace.inner), length=n)
        return jnp.sum(ws)

    def edit(self, key: jax.Array, trace: ScanTrace, request: EditRequest,
             argdiffs: Argdiffs):
        """Full re-scan edit: each step serves its sub-request with the
        (recomputed) carry; carries downstream of any change are treated as
        changed. Correct for all argdiffs (reference optimizes the
        index-edit case, ``scan.py:325-416``)."""
        args = Diff.tree_primal(argdiffs)
        init, xs = args
        n = self._n(args)

        if isinstance(request, IndexRequest):
            if Diff.static_check_no_change(argdiffs):
                return self._edit_index_fast(key, trace, request, args, n)
            # Changed args invalidate the O(1) repair (it would score
            # from the OLD stored step args while recording the new
            # ones). Lower to the equivalent whole-chain request.
            if isinstance(request.subrequest, Update):
                request = Update(
                    request.subrequest.constraint.extend(request.idx)
                )
            elif isinstance(request.subrequest, Regenerate):
                request = Regenerate(
                    request.subrequest.selection.extend(request.idx)
                )
            else:
                # Generic sub-request (HMC / MALA / Rejuvenate / …),
                # round 3: two phases — re-score the whole chain under
                # the changed args with an empty Update, then serve the
                # index edit via the O(1) repair at now-unchanged args.
                # Each phase is weight-antisymmetric on its own, so the
                # composite backward is the repair's IndexRequest (a
                # reversed edit lowers through this same path, scoring
                # back across the reversed argdiffs).
                k_args, k_idx = jax.random.split(key)
                mid_tr, w_args, _rd, _bwd = self.edit(
                    k_args, trace, Update(ChoiceMap.empty()), argdiffs
                )
                new_tr, w_idx, _rd2, bwd = self._edit_index_fast(
                    k_idx, mid_tr, request, args, n
                )
                retdiff = Diff.unknown_change(new_tr.get_retval())
                return new_tr, w_args + w_idx, retdiff, bwd
        if not isinstance(request, (Update, Regenerate)):
            raise NotImplementedError(
                f"Scan does not support {type(request).__name__}"
            )

        def step(carry, inp):
            i, x, inner_tr = inp
            sub_key = jax.random.fold_in(key, i)
            if isinstance(request, Update):
                sub_req: EditRequest = Update(request.constraint.get_submap(i))
            else:
                sub_req = Regenerate(request.selection(i))
            step_diffs = (Diff.unknown_change((carry, x)))
            new_tr, w, _rd, bwd = sub_req.edit(sub_key, inner_tr, step_diffs)
            new_carry, out = new_tr.get_retval()
            discard = (
                bwd.constraint if isinstance(bwd, Update)
                else ChoiceMap.empty()
            )
            return new_carry, (new_tr, w, out, discard)

        final, (new_inner, ws, outs, discards) = lax.scan(
            step, init, (jnp.arange(n), xs, trace.inner), length=n
        )
        new_trace = ScanTrace(self, new_inner, args, (final, outs), n)
        retdiff = Diff.unknown_change(new_trace.get_retval())
        if isinstance(request, Update):
            bwd: EditRequest = Update(Indexed(discards))
        else:
            bwd = Regenerate(request.selection)
        return new_trace, jnp.sum(ws), retdiff, bwd

    def _edit_index_fast(self, key: jax.Array, trace: ScanTrace,
                         request: IndexRequest, args, n: int):
        """O(1) single-step repair (reference ``scan.py:325-416``): edit
        step t, re-score step t+1 under the (possibly changed) carry, and
        require — via an opt-in checkify assertion, in place of the
        reference's trace-time assert — that the carry out of step t+1 is
        unchanged, so no further steps are affected."""
        from genjax_xla.core.checks import optional_check
        from jax.experimental import checkify

        t_idx = jnp.asarray(request.idx)
        init, xs = args

        # -- repair step t -------------------------------------------------
        sub_t = jtu.tree_map(lambda v: v[t_idx], trace.inner)
        k_t, k_next = jax.random.split(key)
        args_t = sub_t.get_args()
        new_sub_t, w_t, _rd, bwd_t = request.subrequest.edit(
            k_t, sub_t, Diff.no_change(args_t)
        )
        carry_out_t, out_t = new_sub_t.get_retval()

        # -- propagate to step t+1 (clipped; weight gated for t = n−1) ----
        t_next = jnp.minimum(t_idx + 1, n - 1)
        has_next = t_idx < (n - 1)
        sub_next = jtu.tree_map(lambda v: v[t_next], trace.inner)
        old_carry_next, _old_out_next = sub_next.get_retval()
        (_old_carry_in, x_next) = sub_next.get_args()
        next_diffs = (
            Diff.tree_diff(carry_out_t, UnknownChange),
            Diff.tree_diff(x_next, NoChange),
        )
        new_sub_next, w_next, _rd2, _bwd2 = Update(ChoiceMap.empty()).edit(
            k_next, sub_next, next_diffs
        )
        new_carry_next, out_next = new_sub_next.get_retval()

        def check():
            # Staged-safe reduction (tree_all would bool-convert traced
            # values); the gate exempts t >= n-2 — a changed carry out
            # of the LAST step has no downstream step and is folded
            # into the final retval below.
            import functools

            same = functools.reduce(
                jnp.logical_and,
                jtu.tree_leaves(jtu.tree_map(
                    lambda a, b: jnp.all(jnp.isclose(a, b)),
                    new_carry_next, old_carry_next,
                )),
                jnp.asarray(True),
            )
            checkify.check(
                same | (t_idx >= n - 2),
                "Scan IndexRequest: the carry changed past step idx+1; "
                "use a full Update/Regenerate edit instead.",
            )
            checkify.check(
                (t_idx >= 0) & (t_idx < n),
                "Scan IndexRequest: index out of range.",
            )

        optional_check(check)

        # -- scatter repaired steps back ----------------------------------
        def put(batched, at, value):
            return jtu.tree_map(
                lambda b, v: b.at[at].set(v), batched, value
            )

        new_inner = put(trace.inner, t_idx, new_sub_t)
        # When t is the last step, t_next clips to t itself — the second
        # write must then re-write the repaired subtrace, not the old one.
        guarded_next = jtu.tree_map(
            lambda new, repaired: jnp.where(has_next, new, repaired),
            new_sub_next, new_sub_t,
        )
        new_inner = put(new_inner, t_next, guarded_next)

        final, outs = trace.retval
        outs = put(outs, t_idx, out_t)
        outs = jtu.tree_map(
            lambda o, v, old: o.at[t_next].set(
                jnp.where(has_next, v, old)
            ),
            outs, out_next, jtu.tree_map(lambda v: v[t_next], outs),
        )
        final = jtu.tree_map(
            lambda f, c_t, c_n: jnp.where(
                t_idx == n - 1, c_t, jnp.where(t_idx == n - 2, c_n, f)
            ),
            final, carry_out_t, new_carry_next,
        )

        new_trace = ScanTrace(self, new_inner, args, (final, outs), n)
        w = w_t + jnp.where(has_next, w_next, 0.0)
        retdiff = Diff.unknown_change(new_trace.get_retval())
        return new_trace, w, retdiff, IndexRequest(t_idx, bwd_t)


def scan(*, n: int | None = None) -> Callable:
    """Decorator: ``@scan(n=10)`` over a ``(carry, x) -> (carry, out)``
    gen fn. Parity: reference ``scan.py:672-760``."""

    def decorator(gen_fn: GenerativeFunction) -> Scan:
        return Scan(gen_fn, n)

    return decorator


# ---------------------------------------------------------------------------
# Derived combinators (parity: reference scan.py:762-1150)
# ---------------------------------------------------------------------------


def prepend_initial_acc(args, ret):
    """Concatenate the initial accumulator onto the stacked outputs.

    Parity: reference ``scan.py:762-789``."""
    init_acc = args[0]
    all_accs = ret

    def cat(init, accs):
        return jnp.concatenate([jnp.asarray(init)[None], accs], axis=0)

    return jtu.tree_map(cat, init_acc, all_accs)


def accumulate() -> Callable:
    """``(acc, x) -> acc`` gen fn  ⇒  ``(init, xs) -> [init, acc1, ...]``
    (like ``jax.lax.associative_scan`` outputs, all intermediate accs).

    Parity: reference ``scan.py:791-852``."""

    def decorator(gen_fn: GenerativeFunction):
        return (
            gen_fn.map(lambda acc: (acc, acc))
            .scan()
            .dimap(
                pre=lambda *args: args,
                post=lambda args, ret: prepend_initial_acc(args, ret[1]),
            )
        )

    return decorator


def reduce() -> Callable:
    """``(acc, x) -> acc`` gen fn  ⇒  ``(init, xs) -> final_acc``.

    Parity: reference ``scan.py:854-914``."""

    def decorator(gen_fn: GenerativeFunction):
        return (
            gen_fn.map(lambda acc: (acc, None))
            .scan()
            .map(lambda ret: ret[0])
        )

    return decorator


def iterate(*, n: int) -> Callable:
    """``x -> x`` gen fn  ⇒  ``x -> [x, f(x), f²(x), ...]`` (n+1 values).

    Parity: reference ``scan.py:916-978``."""

    def decorator(gen_fn: GenerativeFunction):
        return (
            gen_fn.dimap(
                pre=lambda carry, _: (carry,),
                post=lambda args, ret: (ret, ret),
            )
            .scan(n=n)
            .dimap(
                pre=lambda x: (x, None),
                post=lambda args, ret: prepend_initial_acc(args, ret[1]),
            )
        )

    return decorator


def iterate_final(*, n: int) -> Callable:
    """``x -> x`` gen fn  ⇒  ``x -> fⁿ(x)``.

    Parity: reference ``scan.py:980-1048``."""

    def decorator(gen_fn: GenerativeFunction):
        return (
            gen_fn.dimap(
                pre=lambda carry, _: (carry,),
                post=lambda args, ret: (ret, None),
            )
            .scan(n=n)
            .dimap(pre=lambda x: (x, None), post=lambda args, ret: ret[0])
        )

    return decorator


def masked_iterate() -> Callable:
    """``x -> x`` gen fn  ⇒  ``(x, flags) -> [x, ...]`` where lanes with
    ``flags[i]`` False pass the carry through unchanged (masked step).

    Parity: reference ``scan.py:1050-1099``."""

    def decorator(gen_fn: GenerativeFunction):
        from genjax_xla.lang.combinators.mask import MaskCombinator

        masked = MaskCombinator(gen_fn)

        def pre(carry, flag):
            return (flag, carry)

        def post(args, masked_ret):
            (carry, flag) = args
            new = masked_ret.unmask(default=carry)
            return (new, new)

        step = masked.dimap(pre=pre, post=post)
        return step.scan().dimap(
            pre=lambda x, flags: (x, flags),
            post=lambda args, ret: prepend_initial_acc(args, ret[1]),
        )

    return decorator


def masked_iterate_final() -> Callable:
    """Like :func:`masked_iterate` but returning only the final value.

    Parity: reference ``scan.py:1101-1150``."""

    def decorator(gen_fn: GenerativeFunction):
        from genjax_xla.lang.combinators.mask import MaskCombinator

        masked = MaskCombinator(gen_fn)

        def pre(carry, flag):
            return (flag, carry)

        def post(args, masked_ret):
            (carry, flag) = args
            new = masked_ret.unmask(default=carry)
            return (new, None)

        step = masked.dimap(pre=pre, post=post)
        return step.scan().dimap(
            pre=lambda x, flags: (x, flags),
            post=lambda args, ret: ret[0],
        )

    return decorator
