"""``Switch`` combinator: branch selection with existence uncertainty.
All branches are traced (shape placeholders for untaken ones) via
``multi_switch``/``lax.switch``; retval and score are selected with
``tree_choose`` — dense branch evaluation, the batched analogue of
routing (SURVEY §2.3: no expert parallelism needed).

Parity target: ``/root/reference/src/genjax/_src/generative_functions/
combinators/switch.py`` (``SwitchTrace`` :51, ``Switch`` :97, args
convention ``(idx, branch1_args, branch2_args, ...)``, ``switch`` :311).
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp

from genjax_xla.core.pytree import Pytree
from genjax_xla.core.compiler.staging import multi_switch, tree_choose
from genjax_xla.core.compiler.interpreters.incremental import Diff
from genjax_xla.gfi.choice_map import ChoiceMap
from genjax_xla.gfi.concepts import Argdiffs, EditRequest, Score, Weight
from genjax_xla.gfi.gfn import GenerativeFunction, Trace
from genjax_xla.gfi.requests import Regenerate, Update
from genjax_xla.gfi.selection import Selection

__all__ = ["Switch", "SwitchTrace", "switch"]


@Pytree.dataclass
class SwitchTrace(Trace[Any]):
    """All-branch subtraces (taken branch real, others zero placeholders);
    retval/score pre-selected. Parity: reference ``switch.py:51-90``."""

    gen_fn: "Switch"
    args: tuple
    subtraces: tuple
    retval: Any
    score: Score

    def get_idx(self):
        return self.args[0]

    def get_args(self) -> tuple:
        return self.args

    def get_retval(self):
        return self.retval

    def get_score(self) -> Score:
        return self.score

    def get_gen_fn(self):
        return self.gen_fn

    def get_choices(self) -> ChoiceMap:
        return ChoiceMap.switch(
            self.get_idx(), [tr.get_choices() for tr in self.subtraces]
        )

    def get_inner_trace(self, address):
        idx = self.get_idx()
        if isinstance(idx, int):
            return self.subtraces[idx].get_inner_trace(address)
        # Traced index: select leafwise across branches when every
        # branch has the address; with heterogeneous branches, return
        # the unique possessing branch's subtrace directly (the caller
        # is responsible for checking which branch is live — parity:
        # reference ``test_get_subtrace_switch``).
        subs, have = [], []
        for k, tr in enumerate(self.subtraces):
            try:
                subs.append(tr.get_inner_trace(address))
                have.append(k)
            except KeyError:
                # Absent in this branch. (A nested Switch's ambiguity
                # NotImplementedError propagates — swallowing it would
                # silently return another branch's dead placeholder.)
                pass
        if not subs:
            raise KeyError(f"No subtrace at address {address!r}")
        if len(subs) == 1:
            return subs[0]
        if len(subs) == len(self.subtraces):
            return tree_choose(idx, subs)
        raise NotImplementedError(
            f"address {address!r} exists in branches {have} but not "
            "all; select a branch with a concrete index first"
        )


@Pytree.dataclass
class Switch(GenerativeFunction[Any]):
    """Args: ``(idx, branch0_args, branch1_args, ...)``; out-of-bounds
    ``idx`` is clamped."""

    branches: tuple

    def _split_args(self, args):
        idx, branch_args = args[0], args[1:]
        assert len(branch_args) == len(self.branches)
        return idx, branch_args

    def _branch_views(self, chm: ChoiceMap) -> list:
        """Per-branch views of a constraint. A Switch-shaped constraint
        with matching arity unzips so branch ``b`` consumes its OWN
        leaves: after support transforms each branch's values are always
        inside that branch's support, which keeps untaken-branch scoring
        NaN-free under ``grad`` (NUTS/HMC over branch-dependent
        supports). Any other constraint is shared across branches — the
        branch lookup then mask-merges live lanes (an out-of-support
        value fed to an untaken branch scores garbage that
        ``tree_choose`` discards, but its gradient can NaN — prefer
        Switch-shaped constraints for differentiable edits)."""
        from genjax_xla.gfi.choice_map import Switch as SwitchChm

        if isinstance(chm, SwitchChm) and (
            len(chm.branches) == len(self.branches)
        ):
            return list(chm.branches)
        return [chm] * len(self.branches)

    def _build(self, args, subtraces):
        idx, _ = self._split_args(args)
        retval = tree_choose(idx, [tr.get_retval() for tr in subtraces])
        score = tree_choose(idx, [tr.get_score() for tr in subtraces])
        return SwitchTrace(self, args, tuple(subtraces), retval, score)

    def simulate(self, key: jax.Array, args: tuple) -> SwitchTrace:
        idx, branch_args = self._split_args(args)
        fs = [b.simulate for b in self.branches]
        arg_tuples = [(key, a) for a in branch_args]
        subtraces = multi_switch(idx, fs, arg_tuples)
        return self._build(args, subtraces)

    def assess(self, chm: ChoiceMap, args: tuple):
        idx, branch_args = self._split_args(args)
        fs = [b.assess for b in self.branches]
        arg_tuples = [
            (c, a) for c, a in zip(self._branch_views(chm), branch_args)
        ]
        outs = multi_switch(idx, fs, arg_tuples)
        score = tree_choose(idx, [s for s, _ in outs])
        retval = tree_choose(idx, [r for _, r in outs])
        return score, retval

    def generate(self, key: jax.Array, constraint: ChoiceMap, args: tuple):
        idx, branch_args = self._split_args(args)
        fs = [b.generate for b in self.branches]
        arg_tuples = [
            (key, c, a)
            for c, a in zip(self._branch_views(constraint), branch_args)
        ]
        outs = multi_switch(idx, fs, arg_tuples)
        subtraces = [tr for tr, _ in outs]
        w = tree_choose(idx, [w for _, w in outs])
        return self._build(args, subtraces), w

    def project(self, key: jax.Array, trace: SwitchTrace,
                selection: Selection) -> Weight:
        idx, _ = self._split_args(trace.get_args())
        fs = [b.project for b in self.branches]
        arg_tuples = [(key, tr, selection) for tr in trace.subtraces]
        outs = multi_switch(idx, fs, arg_tuples)
        return tree_choose(idx, outs)

    def edit(self, key: jax.Array, trace: SwitchTrace, request: EditRequest,
             argdiffs: Argdiffs):
        """Edit. With an unchanged index, each branch serves the
        sub-request. With a (possibly) changed index, the new branch is
        freshly simulated then constrained (reference ``switch.py:225-303``)
        and the weight picks up the full score delta; unlike the reference
        (whose bwd_request carries a known-wrong TODO), the backward
        request here is the Update carrying ALL of the old trace's
        choices, which restores the previous branch when replayed."""
        if not isinstance(request, (Update, Regenerate)):
            raise NotImplementedError(
                f"Switch does not support {type(request).__name__}"
            )
        args = Diff.tree_primal(argdiffs)
        idx, branch_args = self._split_args(args)
        idx_diff = argdiffs[0]
        if not Diff.static_check_no_change(idx_diff):
            if isinstance(request, Regenerate):
                # Index change + Regenerate: the new branch is freshly
                # simulated (an unconstrained generate). SMCP3
                # bookkeeping with the SELF-INVERSE kernel (bwd is the
                # same Regenerate, whose reverse move resamples the old
                # branch from ITS prior): the fresh branch's density is
                # exactly the forward proposal density and the old
                # branch's exactly the backward one, so they cancel and
                # the switch subtree contributes ZERO —
                #   w = [p(new) + q_bwd(old)] − [p(old) + q_fwd(new)]
                #     = (s_new + s_old) − (s_old + s_new) = 0.
                # Round-5 property-audit fix: the previous Δscore
                # weight made `mh` over traced-index switches accept
                # greedily toward higher-density branches (measured
                # +0.10 posterior bias on a two-branch conjugate
                # model); downstream-likelihood deltas — the true MH
                # alpha — are contributed by the enclosing handler's
                # rescoring of dependent sites.
                new_tr, _w, rd, _bwd = self._edit_index_change(
                    key, trace, Update(ChoiceMap.empty()), args
                )
                return (new_tr, jnp.zeros(()), rd,
                        Regenerate(request.selection))
            return self._edit_index_change(key, trace, request, args)
        # tree_tangent JOINS all branch-arg tangents into one coarse
        # ChangeTangent (sound: NoChange only if everything is unchanged).
        tangent = Diff.tree_tangent(argdiffs[1:])

        if isinstance(request, Update):
            reqs = [
                Update(v) for v in self._branch_views(request.constraint)
            ]
        else:
            reqs = [request] * len(self.branches)

        fs = []
        for b, breq in zip(self.branches, reqs):
            def f(key, tr, a, _req=breq, _tan=tangent):
                new_tr, w, _rd, bwd = _req.edit(
                    key, tr, Diff.tree_diff(a, _tan)
                )
                disc = (
                    bwd.constraint if isinstance(bwd, Update)
                    else ChoiceMap.empty()
                )
                return new_tr, w, disc
            fs.append(f)

        arg_tuples = [
            (key, tr, a)
            for tr, a in zip(trace.subtraces, branch_args)
        ]
        outs = multi_switch(idx, fs, arg_tuples)
        subtraces = [tr for tr, _, _ in outs]
        w = tree_choose(idx, [w for _, w, _ in outs])
        new_trace = self._build(args, subtraces)
        retdiff = Diff.unknown_change(new_trace.get_retval())
        if isinstance(request, Update):
            discard = ChoiceMap.switch(idx, [d for _, _, d in outs])
            bwd: EditRequest = Update(discard)
        else:
            bwd = Regenerate(request.selection)
        return new_trace, w, retdiff, bwd


    def _edit_index_change(self, key: jax.Array, trace: SwitchTrace,
                           request: "Update", args: tuple):
        new_idx, branch_args = self._split_args(args)

        views = self._branch_views(request.constraint)

        fs = []
        for b, view in zip(self.branches, views):
            def f(key, a, _b=b, _view=view):
                new_tr, _w = _b.generate(key, _view, a)
                return (new_tr,)
            fs.append(f)

        arg_tuples = [(key, a) for a in branch_args]
        outs = multi_switch(new_idx, fs, arg_tuples)
        subtraces = [tr for (tr,) in outs]
        new_trace = self._build(args, subtraces)
        # Full score delta: the new branch's choices replace the old
        # branch's entirely (reference switch.py:289-293 and the pinned
        # ``w == Δscore`` contract in test_combinators.py). Round-5
        # property-test fix: the previous simulate-then-edit form added
        # the edit weight relative to the DISCARDED fresh simulation —
        # pure auxiliary machinery that double-counted constrained
        # sites (an identity Update through a traced-index switch
        # returned a random nonzero weight). ``generate`` constrains
        # directly; the weight is the score delta alone.
        weight = new_trace.get_score() - trace.get_score()
        retdiff = Diff.unknown_change(new_trace.get_retval())
        bwd = Update(trace.get_choices())
        return new_trace, weight, retdiff, bwd


def switch(*branches: GenerativeFunction) -> Switch:
    from genjax_xla.core.argcheck import check_gen_fns

    check_gen_fns(branches, "switch")
    """Parity: reference ``switch.py:311-354``."""
    return Switch(tuple(branches))
