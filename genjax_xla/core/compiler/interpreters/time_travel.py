"""Time-travel debugger: execute a staged function while recording a frame
at every ``rec``/``tag`` point — then step forward/backward through frames,
jump to tags, resume execution from any frame, and re-execute with new
arguments (``remix``).

Parity target: ``/root/reference/src/genjax/_src/core/compiler/
interpreters/time_travel.py`` (``record_p`` :42, ``rec``/``tag`` :82-95,
``TimeTravelCPSInterpreter`` :104-194, ``TimeTravelingDebugger.fwd/bwd/
jump/remix`` :201-267, ``time_machine`` :287).

Architecture difference: the reference builds hybrid-CPS continuation
closures; here frames snapshot the interpreter environment + the remaining
equation index — resumption just replays the jaxpr tail from the snapshot.
Same capabilities, no CPS machinery.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import jax.tree_util as jtu

from genjax_xla.core.compiler.staging import stage
from genjax_xla.core.compiler.initial_style_primitive import (
    InitialStylePrimitive,
    initial_style_bind,
)
from genjax_xla.core.compiler.interpreters.environment import Environment

__all__ = ["rec", "tag", "time_machine", "TimeTravelingDebugger"]

record_p = InitialStylePrimitive("record")


def rec(v, *, name: str | None = None):
    """Record a debugger frame holding ``v`` (identity on the value)."""

    def identity(v):
        return v

    return initial_style_bind(record_p, tag=name)(identity)(v)


def tag(name: str):
    """Curried form: ``x = tag("x")(x)``."""

    def bind(v):
        return rec(v, name=name)

    return bind


@dataclasses.dataclass
class Frame:
    """One recorded instant: the tagged value, the environment snapshot,
    and the index of the next equation to execute."""

    tag: str | None
    value: Any
    env: dict
    eqn_idx: int


class TimeTravelingDebugger:
    """Navigate recorded frames of one execution.

    ``fwd`` / ``bwd`` move the cursor; ``jump(tag)`` moves to the first
    frame with that tag; ``frame.value`` inspects the recorded value;
    ``resume()`` replays the remaining program from the cursor and returns
    the final output; ``remix(*args)`` re-executes from scratch on new
    arguments (a fresh debugger)."""

    def __init__(self, fn: Callable, args: tuple, frames: list[Frame],
                 final: Any, closed_jaxpr, out_tree):
        self._fn = fn
        self._args = args
        self.frames = frames
        self.final = final
        self._closed_jaxpr = closed_jaxpr
        self._out_tree = out_tree
        self.cursor = 0

    # -- navigation -------------------------------------------------------

    @property
    def frame(self) -> Frame:
        return self.frames[self.cursor]

    def fwd(self) -> "TimeTravelingDebugger":
        self.cursor = min(self.cursor + 1, len(self.frames) - 1)
        return self

    def bwd(self) -> "TimeTravelingDebugger":
        self.cursor = max(self.cursor - 1, 0)
        return self

    def jump(self, tag: str) -> "TimeTravelingDebugger":
        for i, f in enumerate(self.frames):
            if f.tag == tag:
                self.cursor = i
                return self
        raise KeyError(f"No frame tagged {tag!r}")

    # -- execution --------------------------------------------------------

    def resume(self, value: Any | None = None):
        """Replay the program tail from the cursor frame; optionally
        substitute ``value`` for the recorded value at this frame."""
        frame = self.frame
        jaxpr = self._closed_jaxpr.jaxpr
        env = Environment()
        env.env = dict(frame.env)
        eqn = jaxpr.eqns[frame.eqn_idx]
        # Write the record eqn's outputs (the recorded/substituted value).
        v = frame.value if value is None else value
        flat = jtu.tree_leaves(v)
        for var, val in zip(eqn.outvars, flat):
            env[var] = val
        out_flat = _eval_tail(jaxpr, env, frame.eqn_idx + 1)
        return jtu.tree_unflatten(self._out_tree, out_flat)

    def remix(self, *new_args) -> "TimeTravelingDebugger":
        """Re-execute from the beginning with new arguments."""
        return time_machine(self._fn)(*new_args)

    def __repr__(self):
        marks = [
            ("*" if i == self.cursor else " ")
            + (f.tag or f"frame{i}")
            for i, f in enumerate(self.frames)
        ]
        return f"<TimeTravelingDebugger [{', '.join(marks)}]>"


def _eval_tail(jaxpr, env: Environment, start: int):
    for eqn in jaxpr.eqns[start:]:
        invals = [env[v] for v in eqn.invars]
        subfuns, params = eqn.primitive.get_bind_params(eqn.params)
        if eqn.primitive is record_p:
            num_consts = eqn.params["num_consts"]
            outs = invals[num_consts:]
        else:
            outs = eqn.primitive.bind(*subfuns, *invals, **params)
            if not eqn.primitive.multiple_results:
                outs = [outs]
        for var, val in zip(eqn.outvars, outs):
            env[var] = val
    return [env[v] for v in jaxpr.outvars]


def time_machine(fn: Callable):
    """``time_machine(fn)(*args)`` — run ``fn`` recording frames at every
    :func:`rec`/:func:`tag` point; returns a
    :class:`TimeTravelingDebugger`."""

    def run(*args) -> TimeTravelingDebugger:
        closed_jaxpr, (_, out_tree, _) = stage(fn)(*args)
        jaxpr = closed_jaxpr.jaxpr
        env = Environment()
        for var, val in zip(jaxpr.constvars, closed_jaxpr.consts):
            env[var] = val
        for var, val in zip(jaxpr.invars, jtu.tree_leaves(args)):
            env[var] = val

        frames: list[Frame] = []
        for idx, eqn in enumerate(jaxpr.eqns):
            invals = [env[v] for v in eqn.invars]
            subfuns, params = eqn.primitive.get_bind_params(eqn.params)
            if eqn.primitive is record_p:
                num_consts = eqn.params["num_consts"]
                in_tree = eqn.params["in_tree"]
                flat_val = invals[num_consts:]
                (value,) = jtu.tree_unflatten(in_tree, flat_val)
                frames.append(
                    Frame(eqn.params.get("tag"), value, dict(env.env), idx)
                )
                outs = flat_val
            else:
                outs = eqn.primitive.bind(*subfuns, *invals, **params)
                if not eqn.primitive.multiple_results:
                    outs = [outs]
            for var, val in zip(eqn.outvars, outs):
                env[var] = val

        out_flat = [env[v] for v in jaxpr.outvars]
        final = jtu.tree_unflatten(out_tree, out_flat)
        return TimeTravelingDebugger(
            fn, args, frames, final, closed_jaxpr, out_tree
        )

    return run
