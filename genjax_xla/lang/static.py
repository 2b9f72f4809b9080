"""The ``@gen`` static modeling language.

Functional parity target: ``/root/reference/src/genjax/_src/generative_functions/
static.py`` (``StaticGenerativeFunction``, the five GFI transforms, the
``x = gf(args) @ "addr"`` addressing sugar, ``AddressReuse``/``MissingAddress``
errors, deterministic per-site keys via ``jax.random.fold_in``).

Architecture difference (deliberate): the reference stages the model
body to a jaxpr and re-interprets it equation-by-equation under stateful /
incremental interpreters (``static.py:254-717``). Here the body is executed as
*plain Python* under a dynamic handler stack: ``@ "addr"`` dispatches to the
innermost active :class:`StaticHandler`. Because JAX tracing is itself a Python
execution, this composes with ``jit`` / ``vmap`` / ``shard_map`` with no
interpretation overhead, no custom primitives, and no jaxpr walking — the
traced XLA program is identical, the trace-time cost is lower, and there is no
2nd interpreter to keep in sync with JAX internals. For Update/Regenerate
edits, fine-grained incremental re-scoring stages the body once and runs the
jaxpr-level Diff interpreter over it (``lang/static_edit.py``), re-scoring
only sites whose inputs actually changed — matching the reference's
``incremental.py:316-346`` capability; bodies needing concrete control flow
fall back to the coarser (still sound) handler rule: a site/return value is
``NoChange`` only when *all* of its (statically known) inputs are unchanged.

Weight/score conventions follow the GFI exactly (see
``genjax_xla/gfi/concepts.py``); the SMCP3 edit-weight identities are enforced
by ``tests/lang/test_static.py``.
"""

from __future__ import annotations

import functools
from typing import Any, Callable

import jax
import jax.numpy as jnp

from genjax_xla.core.pytree import Pytree
from genjax_xla.core.compiler.interpreters.incremental import Diff
from genjax_xla.gfi.choice_map import ChoiceMap
from genjax_xla.gfi.concepts import (
    Argdiffs,
    EditRequest,
    Retdiff,
    Score,
    Weight,
)
from genjax_xla.gfi.gfn import GenerativeFunction, Trace
from genjax_xla.gfi.requests import Regenerate, Update
from genjax_xla.gfi.selection import Selection

__all__ = [
    "gen",
    "Fn",
    "StaticTrace",
    "StaticRequest",
    "trace_here",
    "AddressReuse",
    "MissingAddress",
]


class AddressReuse(Exception):
    """Same address traced twice in one ``@gen`` body.

    Parity: reference ``static.py:139-144``."""


class MissingAddress(Exception):
    """``assess`` called with a choice map missing a traced address.

    Parity: reference ``static.py:147-151``."""


# ---------------------------------------------------------------------------
# Handler stack
# ---------------------------------------------------------------------------


_HANDLER_STACK: list["StaticHandler"] = []

# Fine-grained incremental edits (stage the body + Diff interpreter; see
# lang/static_edit.py). Set False to force the coarse handler path.
FINE_GRAINED_EDITS = True

#: handle_kwargs wrapper fallback cache for callables without a ``__dict__``
#: (see Fn.handle_kwargs). The common case caches on the source function
#: itself so the wrapper's lifetime is tied to its source; a weak-key dict
#: would not work here because the cached Fn closes over the source (the
#: value would strongly reference the key, pinning the entry forever).
_KWARGED_FNS: dict = {}


def trace_here(addr, gen_fn: GenerativeFunction, args: tuple):
    """Record a traced call at ``addr`` under the innermost active handler.

    This is the runtime of the ``gf(args) @ "addr"`` sugar
    (``gfn.py:GenerativeFunctionClosure.__matmul__``)."""
    if not _HANDLER_STACK:
        raise RuntimeError(
            "Traced calls (`gf(args) @ addr`) only make sense inside a "
            "@gen function body being executed by the GFI."
        )
    if isinstance(addr, tuple):
        # Tupled address sugar: ``gf(args) @ ("x", "x0")`` nests the
        # choice at the static path (parity: reference
        # ``tests/core/generative/test_core.py test_tupled_address``).
        if not addr or not all(isinstance(c, (str, int)) for c in addr):
            raise TypeError(
                "Tupled trace addresses must be non-empty tuples of "
                f"static str/int components, got {addr!r}."
            )
        if len(addr) == 1:
            addr = addr[0]
    elif not isinstance(addr, (str, int)):
        raise TypeError(
            f"Trace addresses must be static str or int, got {addr!r}."
        )
    handler = _HANDLER_STACK[-1]
    return handler.handle(addr, gen_fn, args)


def validate_new_address(addresses, addr):
    """Shared address validation for both edit paths (coarse handlers
    here and the staging handler in ``static_edit.py``): exact reuse,
    plus prefix conflicts — a tupled address nested under (or
    enclosing) another site's path would collide in the choice trie,
    e.g. ``("x", "y")`` after ``"x"``. The reference leaves the prefix
    check unimplemented (its ``test_tupled_address_conflict`` is
    skipped); here it is an AddressReuse at trace time."""
    if addr in addresses:
        raise AddressReuse(addr)
    t = addr if isinstance(addr, tuple) else (addr,)
    for seen in addresses:
        s = seen if isinstance(seen, tuple) else (seen,)
        k = min(len(s), len(t))
        if s[:k] == t[:k]:
            raise AddressReuse(addr)


class StaticHandler:
    """Base: bookkeeping shared by the five GFI transforms."""

    def __init__(self):
        self.addresses: list = []
        self.subtraces: list[Trace] = []

    def visit(self, addr):
        validate_new_address(self.addresses, addr)
        self.addresses.append(addr)

    def record(self, subtrace: Trace):
        self.subtraces.append(subtrace)

    def handle(self, addr, gen_fn: GenerativeFunction, args: tuple):
        raise NotImplementedError

    def __enter__(self):
        _HANDLER_STACK.append(self)
        return self

    def __exit__(self, *exc):
        popped = _HANDLER_STACK.pop()
        assert popped is self
        return False


class SimulateHandler(StaticHandler):
    def __init__(self, key):
        super().__init__()
        self.key = key
        self.counter = 0

    def handle(self, addr, gen_fn, args):
        self.visit(addr)
        sub_key = jax.random.fold_in(self.key, self.counter)
        self.counter += 1
        subtrace = gen_fn.simulate(sub_key, args)
        self.record(subtrace)
        return subtrace.get_retval()


class AssessHandler(StaticHandler):
    def __init__(self, chm: ChoiceMap):
        super().__init__()
        self.chm = chm
        self.score = jnp.zeros(())

    def handle(self, addr, gen_fn, args):
        self.visit(addr)
        submap = self.chm.get_submap(addr)
        if submap.static_is_empty():
            raise MissingAddress(addr)
        score, retval = gen_fn.assess(submap, args)
        self.score = self.score + score
        return retval


class GenerateHandler(StaticHandler):
    def __init__(self, key, constraint: ChoiceMap):
        super().__init__()
        self.key = key
        self.constraint = constraint
        self.counter = 0
        self.weight = jnp.zeros(())

    def handle(self, addr, gen_fn, args):
        self.visit(addr)
        sub_key = jax.random.fold_in(self.key, self.counter)
        self.counter += 1
        submap = self.constraint.get_submap(addr)
        subtrace, w = gen_fn.generate(sub_key, submap, args)
        self.weight = self.weight + w
        self.record(subtrace)
        return subtrace.get_retval()


class UpdateHandler(StaticHandler):
    """Serve ``Update(constraint)``: constrain some addresses to new values,
    replay the rest (rescored under possibly-changed args).

    Parity: reference ``static.py:407-509`` (UpdateHandler + transform)."""

    def __init__(self, key, previous: "StaticTrace", constraint: ChoiceMap,
                 args_changed: bool):
        super().__init__()
        self.key = key
        self.previous = previous
        self.constraint = constraint
        self.counter = 0
        self.weight = jnp.zeros(())
        self.discard: list[tuple[Any, ChoiceMap]] = []
        self.any_change = args_changed

    def handle(self, addr, gen_fn, args):
        self.visit(addr)
        sub_key = jax.random.fold_in(self.key, self.counter)
        self.counter += 1
        submap = self.constraint.get_submap(addr)
        try:
            old_sub = self.previous.get_inner_trace(addr)
        except KeyError:
            # Newly-visited address (concrete control flow exposed a
            # site the old trace never ran): importance-generate it —
            # the generate weight is exactly the SMCP3 increment for a
            # fresh site (reference ``static.py:443-466`` handles the
            # same case through its jaxpr walk).
            new_sub, w = gen_fn.generate(sub_key, submap, args)
            self.any_change = True
            self.weight = self.weight + w
            self.record(new_sub)
            return new_sub.get_retval()
        argdiffs = (
            Diff.unknown_change(args) if self.any_change
            else Diff.no_change(args)
        )
        new_sub, w, retdiff, bwd = gen_fn.edit(
            sub_key, old_sub, Update(submap), argdiffs
        )
        if not Diff.static_check_no_change(retdiff):
            self.any_change = True
        if isinstance(bwd, Update) and not bwd.constraint.static_is_empty():
            self.discard.append((addr, bwd.constraint))
        self.weight = self.weight + w
        self.record(new_sub)
        return new_sub.get_retval()

    def settle_dropped(self):
        """Addresses the old trace visited but the new execution did
        not: subtract their scores from the weight and move their
        choices to the discard (the backward Update restores them)."""
        visited = set(self.addresses)
        for addr, sub in zip(self.previous.addresses,
                             self.previous.subtraces):
            if addr not in visited:
                self.any_change = True
                self.weight = self.weight - sub.get_score()
                self.discard.append((addr, sub.get_choices()))


class RegenerateHandler(StaticHandler):
    """Serve ``Regenerate(selection)``: resample selected addresses from
    their prior conditionals. Parity: reference ``static.py:616-717``."""

    def __init__(self, key, previous: "StaticTrace", selection: Selection,
                 args_changed: bool):
        super().__init__()
        self.key = key
        self.previous = previous
        self.selection = selection
        self.counter = 0
        self.weight = jnp.zeros(())
        self.any_change = args_changed

    def handle(self, addr, gen_fn, args):
        self.visit(addr)
        sub_key = jax.random.fold_in(self.key, self.counter)
        self.counter += 1
        subsel = self.selection(addr)
        try:
            old_sub = self.previous.get_inner_trace(addr)
        except KeyError:
            # Newly-visited address: a fresh prior draw (weight 0 —
            # proposal and target contributions cancel exactly).
            new_sub = gen_fn.simulate(sub_key, args)
            self.any_change = True
            self.record(new_sub)
            return new_sub.get_retval()
        argdiffs = (
            Diff.unknown_change(args) if self.any_change
            else Diff.no_change(args)
        )
        new_sub, w, retdiff, _bwd = gen_fn.edit(
            sub_key, old_sub, Regenerate(subsel), argdiffs
        )
        if not Diff.static_check_no_change(retdiff):
            self.any_change = True
        self.weight = self.weight + w
        self.record(new_sub)
        return new_sub.get_retval()

    def settle_dropped(self):
        """Subtract dropped addresses' scores (their choices are
        gone; the weight must stop counting them)."""
        visited = set(self.addresses)
        for addr, sub in zip(self.previous.addresses,
                             self.previous.subtraces):
            if addr not in visited:
                self.any_change = True
                self.weight = self.weight - sub.get_score()


class StaticEditHandler(StaticHandler):
    """Serve :class:`StaticRequest`: an arbitrary sub-request per address.

    Parity: reference ``static.py:512-613``."""

    def __init__(self, key, previous: "StaticTrace",
                 requests: dict, args_changed: bool):
        super().__init__()
        self.key = key
        self.previous = previous
        self.requests = requests
        self.counter = 0
        self.weight = jnp.zeros(())
        self.bwd: dict = {}
        self.any_change = args_changed

    def handle(self, addr, gen_fn, args):
        self.visit(addr)
        sub_key = jax.random.fold_in(self.key, self.counter)
        self.counter += 1
        request = self.requests.get(addr, Update(ChoiceMap.empty()))
        old_sub = self.previous.get_inner_trace(addr)
        argdiffs = (
            Diff.unknown_change(args) if self.any_change
            else Diff.no_change(args)
        )
        new_sub, w, retdiff, bwd = request.edit(sub_key, old_sub, argdiffs)
        if not Diff.static_check_no_change(retdiff):
            self.any_change = True
        self.weight = self.weight + w
        self.bwd[addr] = bwd
        self.record(new_sub)
        return new_sub.get_retval()


# ---------------------------------------------------------------------------
# Trace
# ---------------------------------------------------------------------------


@Pytree.dataclass
class StaticTrace(Trace[Any]):
    """Trace of a ``@gen`` function: per-address subtraces; score is the sum
    of subtrace scores. Parity: reference ``static.py:80-119``."""

    gen_fn: "Fn"
    args: tuple
    retval: Any
    subtraces: tuple
    addresses: tuple = Pytree.static()

    def get_args(self) -> tuple:
        return self.args

    def get_retval(self):
        return self.retval

    def get_gen_fn(self):
        return self.gen_fn

    def get_score(self) -> Score:
        score = jnp.zeros(())
        for sub in self.subtraces:
            score = score + sub.get_score()
        return score

    def get_choices(self) -> ChoiceMap:
        chm = ChoiceMap.empty()
        for addr, sub in zip(self.addresses, self.subtraces):
            chm = chm | sub.get_choices().extend(addr)
        return chm

    def get_inner_trace(self, address) -> Trace:
        for addr, sub in zip(self.addresses, self.subtraces):
            if addr == address:
                return sub
        # Component-wise descent into tupled sites: a site traced at
        # ("x", "x0") is reachable as get_subtrace("x", "x0") — the
        # first component yields a prefix view over the matching
        # suffixes (consistent with the choice-trie view).
        matches = tuple(
            (addr[1:] if len(addr) > 2 else addr[1], sub)
            for addr, sub in zip(self.addresses, self.subtraces)
            if isinstance(addr, tuple) and addr[0] == address
        )
        if matches:
            return _PrefixTrace(
                tuple(a for a, _ in matches),
                tuple(s for _, s in matches),
            )
        raise KeyError(f"No subtrace at address {address!r}")


@Pytree.dataclass
class _PrefixTrace(Trace[Any]):
    """View over the subtraces under one component of tupled
    addresses: supports further ``get_inner_trace`` descent,
    ``get_choices``, and ``get_score`` (sum of the group)."""

    addresses: tuple = Pytree.static()
    subtraces: tuple = ()

    def get_args(self) -> tuple:
        return ()

    def get_retval(self):
        return None

    def get_gen_fn(self):
        return None

    def get_score(self) -> Score:
        score = jnp.zeros(())
        for sub in self.subtraces:
            score = score + sub.get_score()
        return score

    def get_choices(self) -> ChoiceMap:
        chm = ChoiceMap.empty()
        for addr, sub in zip(self.addresses, self.subtraces):
            chm = chm | sub.get_choices().extend(addr)
        return chm

    get_inner_trace = StaticTrace.get_inner_trace


@Pytree.dataclass
class StaticRequest(EditRequest):
    """Address-wise edit: apply ``requests[addr]`` to the subtrace at
    ``addr`` (default: no-op Update). Parity: reference ``static.py:129``."""

    addressed: dict = Pytree.field(default_factory=dict)

    def edit(self, key, tr: StaticTrace, argdiffs: Argdiffs):
        gen_fn = tr.get_gen_fn()
        return gen_fn.edit(key, tr, self, argdiffs)


# ---------------------------------------------------------------------------
# The generative function
# ---------------------------------------------------------------------------


@Pytree.dataclass
class Fn(GenerativeFunction[Any]):
    """A ``@gen``-decorated Python function as a generative function.

    Parity: reference ``StaticGenerativeFunction`` (``static.py:725-1041``).
    """

    source: Callable = Pytree.static()

    @property
    def __wrapped__(self):
        return self.source

    @property
    def __name__(self):
        return getattr(self.source, "__name__", "gen_fn")

    def __get__(self, instance, _owner):
        # Method models: bind `self` like a normal function would.
        if instance is None:
            return self
        return self.partial_apply(instance)

    # -- GFI --------------------------------------------------------------

    def simulate(self, key: jax.Array, args: tuple) -> StaticTrace:
        with SimulateHandler(key) as h:
            retval = self.source(*args)
        return StaticTrace(
            self, args, retval, tuple(h.subtraces), tuple(h.addresses)
        )

    def assess(self, chm: ChoiceMap, args: tuple):
        with AssessHandler(chm) as h:
            retval = self.source(*args)
        return h.score, retval

    def generate(self, key: jax.Array, constraint: ChoiceMap, args: tuple):
        with GenerateHandler(key, constraint) as h:
            retval = self.source(*args)
        trace = StaticTrace(
            self, args, retval, tuple(h.subtraces), tuple(h.addresses)
        )
        return trace, h.weight

    def project(self, key: jax.Array, trace: StaticTrace,
                selection: Selection) -> Weight:
        w = jnp.zeros(())
        for i, (addr, sub) in enumerate(
            zip(trace.addresses, trace.subtraces)
        ):
            sub_key = jax.random.fold_in(key, i)
            w = w + sub.get_gen_fn().project(sub_key, sub, selection(addr))
        return w

    def edit(self, key: jax.Array, trace: StaticTrace, request: EditRequest,
             argdiffs: Argdiffs):
        args = Diff.tree_primal(argdiffs)
        args_changed = not Diff.static_check_no_change(argdiffs)
        if FINE_GRAINED_EDITS and isinstance(
            request, (Update, Regenerate, StaticRequest)
        ):
            try:
                return self._edit_incremental(key, trace, request, argdiffs)
            except (
                jax.errors.TracerBoolConversionError,
                jax.errors.ConcretizationTypeError,
                jax.errors.TracerArrayConversionError,
                jax.errors.TracerIntegerConversionError,
                # Non-jaxtype args (strings, arbitrary Python objects)
                # make make_jaxpr raise TypeError — such bodies run fine
                # through the plain-Python coarse path below.
                TypeError,
            ):
                # Body needs concrete control flow — staging impossible;
                # the coarse handler path below executes it as plain
                # Python (sound, just O(sites) re-scoring).
                pass
        if isinstance(request, Update):
            h: Any = UpdateHandler(key, trace, request.constraint, args_changed)
            with h:
                retval = self.source(*args)
            h.settle_dropped()
            new_trace = StaticTrace(
                self, args, retval, tuple(h.subtraces), tuple(h.addresses)
            )
            discard = ChoiceMap.empty()
            for addr, sub_discard in h.discard:
                discard = discard | sub_discard.extend(addr)
            retdiff = (
                Diff.unknown_change(retval) if h.any_change
                else Diff.no_change(retval)
            )
            return new_trace, h.weight, retdiff, Update(discard)
        elif isinstance(request, Regenerate):
            h = RegenerateHandler(key, trace, request.selection, args_changed)
            with h:
                retval = self.source(*args)
            h.settle_dropped()
            new_trace = StaticTrace(
                self, args, retval, tuple(h.subtraces), tuple(h.addresses)
            )
            retdiff = (
                Diff.unknown_change(retval) if h.any_change
                else Diff.no_change(retval)
            )
            return new_trace, h.weight, retdiff, Regenerate(request.selection)
        elif isinstance(request, StaticRequest):
            h = StaticEditHandler(key, trace, request.addressed, args_changed)
            with h:
                retval = self.source(*args)
            new_trace = StaticTrace(
                self, args, retval, tuple(h.subtraces), tuple(h.addresses)
            )
            retdiff = (
                Diff.unknown_change(retval) if h.any_change
                else Diff.no_change(retval)
            )
            return new_trace, h.weight, retdiff, StaticRequest(h.bwd)
        raise NotImplementedError(
            f"Fn does not support request {type(request).__name__}"
        )

    def _edit_incremental(self, key, trace, request, argdiffs):
        """Fine-grained edit: stage the body (sites as ``site_p`` eqns) and
        run the incremental (Diff) interpreter so only sites whose inputs
        actually changed are re-scored. Parity with the reference's
        update/regenerate transforms (``static.py:443-466`` +
        ``incremental.py:316-346``); see ``lang/static_edit.py``."""
        from genjax_xla.lang.static_edit import edit_via_incremental

        new_trace, weight, retdiff, ctx = edit_via_incremental(
            self, key, trace, request, argdiffs
        )
        if isinstance(request, Update):
            discard = ChoiceMap.empty()
            for addr, sub_discard in ctx.discard:
                discard = discard | sub_discard.extend(addr)
            return new_trace, weight, retdiff, Update(discard)
        if isinstance(request, Regenerate):
            return new_trace, weight, retdiff, Regenerate(request.selection)
        return new_trace, weight, retdiff, StaticRequest(ctx.bwd)

    # -- ergonomics -------------------------------------------------------

    def inline(self, *args):
        """Execute the body under the *current* handler (no address
        nesting). Parity: reference ``static.py:991-1009``."""
        return self.source(*args)

    def handle_kwargs(self) -> "Fn":
        """Kwarg-accepting form: args become ``(args_tuple, kwargs_dict)``
        and are applied to the source. Parity: reference
        ``static.py:780-785``.

        The wrapper is CACHED per source: it lives in the trace treedef
        (static field), and a fresh closure per call would make two
        traces of the same model structurally unequal — breaking
        ``tree_map`` over trace pairs (MH accept/reject), ``lax.scan``
        carries, and vmap."""
        source = self.source
        inst_dict = getattr(source, "__dict__", None)
        cache = inst_dict if isinstance(inst_dict, dict) else _KWARGED_FNS
        cache_key = "__genjax_kwarged__" if cache is inst_dict else source
        fn = cache.get(cache_key)
        if fn is None:

            def kwarged_source(args, kwargs):
                return source(*args, **kwargs)

            fn = Fn(kwarged_source)
            try:
                cache[cache_key] = fn
            except TypeError:  # unhashable exotic callable: skip caching
                pass
        return fn

    def partial_apply(self, *pre_args) -> "Fn":
        """Fix leading arguments (STATIC values only — the partial lives in
        the treedef). Parity: reference ``static.py:1011-1040``."""
        import jax.core as _core

        for a in pre_args:
            for leaf in jax.tree_util.tree_leaves(a):
                if isinstance(leaf, _core.Tracer):
                    raise TypeError(
                        "partial_apply received a traced value; traced "
                        "arguments must flow through the gen fn's normal "
                        "argument list (or a Closure), not the static "
                        "partial."
                    )
        partial = functools.partial(self.source, *pre_args)
        functools.update_wrapper(partial, self.source)
        return Fn(partial)


def gen(fn: Callable) -> Fn:
    """Decorator: Python function → generative function.

    Example::

        @gen
        def model(mu):
            x = normal(mu, 1.0) @ "x"
            y = normal(x, 0.1) @ "y"
            return y
    """
    return Fn(fn)
