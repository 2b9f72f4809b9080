"""The generative function interface (GFI): ``Trace`` and
``GenerativeFunction``, the measure-theoretic core every model and inference
algorithm in the framework speaks through.

Parity target:
``/root/reference/src/genjax/_src/core/generative/generative_function.py``
(``Trace`` :72-230, ``GenerativeFunction`` :238-1486,
``GenerativeFunctionClosure`` :1557-1684). Combinator postfix methods import
lazily from ``genjax_xla.lang.combinators``.
"""

from __future__ import annotations

import abc
from typing import Any, Callable, Generic, TypeVar

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
from genjax_xla.gfi.selection import Selection

R = TypeVar("R")

__all__ = ["Trace", "GenerativeFunction", "GenerativeFunctionClosure"]


class Trace(Pytree, Generic[R]):
    """A recording of one execution of a generative function: arguments,
    return value, choices, and score (log density of the choices).

    Scores follow the reference convention (``generative_function.py:378``):
    ``get_score() = log P(choices; args)`` for exact-density models, or a
    single-sample unbiased *density-reciprocal* estimator otherwise.
    """

    # -- abstract getters -------------------------------------------------

    @abc.abstractmethod
    def get_args(self) -> tuple: ...

    @abc.abstractmethod
    def get_retval(self) -> R: ...

    @abc.abstractmethod
    def get_score(self) -> Score: ...

    @abc.abstractmethod
    def get_choices(self) -> ChoiceMap: ...

    @abc.abstractmethod
    def get_gen_fn(self) -> "GenerativeFunction[R]": ...

    # -- conveniences -----------------------------------------------------

    def get_sample(self) -> ChoiceMap:
        return self.get_choices()

    def edit(
        self,
        key: jax.Array,
        request: EditRequest,
        argdiffs: Argdiffs | None = None,
    ) -> "tuple[Trace[R], Weight, Retdiff, EditRequest]":
        """Apply an edit request to this trace (SMCP3 move)."""
        if argdiffs is None:
            argdiffs = Diff.no_change(self.get_args())
        return request.edit(key, self, argdiffs)

    def update(
        self,
        key: jax.Array,
        constraint: ChoiceMap,
        argdiffs: Argdiffs | None = None,
    ) -> "tuple[Trace[R], Weight, Retdiff, ChoiceMap]":
        """Constrain-update this trace; returns the discarded choices."""
        if argdiffs is None:
            argdiffs = Diff.no_change(self.get_args())
        return self.get_gen_fn().update(key, self, constraint, argdiffs)

    def project(self, key: jax.Array, selection: Selection) -> Weight:
        """log-density of the selected choices, conditioned on the rest."""
        gen_fn = self.get_gen_fn()
        return gen_fn.project(key, self, selection)

    def get_subtrace(self, *addresses) -> "Trace[Any]":
        tr: Trace[Any] = self
        for addr in addresses:
            tr = tr.get_inner_trace(addr)
        return tr

    def get_inner_trace(self, address) -> "Trace[Any]":
        # KeyError = "address absent here" (the StaticTrace convention),
        # so containers like Switch can distinguish absence from a
        # nested trace's genuine NotImplementedError (e.g. ambiguous
        # possession across traced-index branches).
        raise KeyError(
            f"{type(self).__name__} has no subtraces"
        )

    def batch_shape(self) -> tuple:
        return jnp.shape(self.get_score())


class GenerativeFunction(Pytree, Generic[R]):
    """A probability measure over structured sample spaces, accessed through
    five methods: ``simulate`` / ``assess`` / ``generate`` / ``project`` /
    ``edit``. Inference algorithms speak only this interface.
    """

    def __init_subclass__(cls, **kwargs):
        # Trace-time argument validation on every concrete GFI method —
        # the repo's beartype replacement (core/validate.py; parity:
        # reference installs beartype package-wide, __init__.py:23-33).
        super().__init_subclass__(**kwargs)
        from genjax_xla.core.validate import install_gfi_checks

        install_gfi_checks(cls)

    # -- the five methods -------------------------------------------------

    @abc.abstractmethod
    def simulate(self, key: jax.Array, args: tuple) -> Trace[R]:
        """Sample a trace: choices ~ P(·; args)."""

    @abc.abstractmethod
    def assess(self, chm: ChoiceMap, args: tuple) -> tuple[Score, R]:
        """Score a *complete* choice map: ``(log P(chm; args), retval)``."""

    @abc.abstractmethod
    def generate(
        self, key: jax.Array, constraint: ChoiceMap, args: tuple
    ) -> tuple[Trace[R], Weight]:
        """Importance-sample a trace consistent with ``constraint``; the
        weight is ``log P(choices) − log q(unconstrained | constraint)``."""

    def project(
        self, key: jax.Array, trace: Trace[R], selection: Selection
    ) -> Weight:
        """Weight of removing the selected choices from the trace."""
        raise NotImplementedError

    def edit(
        self,
        key: jax.Array,
        trace: Trace[R],
        request: EditRequest,
        argdiffs: Argdiffs,
    ) -> tuple[Trace[R], Weight, Retdiff, EditRequest]:
        """Serve a primitive edit request (SMCP3 move)."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support request "
            f"{type(request).__name__}"
        )

    # -- derived methods --------------------------------------------------

    def update(
        self,
        key: jax.Array,
        trace: Trace[R],
        constraint: ChoiceMap,
        argdiffs: Argdiffs,
    ) -> tuple[Trace[R], Weight, Retdiff, ChoiceMap]:
        from genjax_xla.gfi.requests import Update

        tr, w, rd, bwd = Update(constraint).edit(key, trace, argdiffs)
        discard = bwd.constraint if isinstance(bwd, Update) else ChoiceMap.empty()
        return tr, w, rd, discard

    def importance(
        self, key: jax.Array, constraint: ChoiceMap, args: tuple
    ) -> tuple[Trace[R], Weight]:
        return self.generate(key, constraint, args)

    def propose(self, key: jax.Array, args: tuple):
        tr = self.simulate(key, args)
        return tr.get_choices(), tr.get_score(), tr.get_retval()

    def get_zero_trace(self, *args) -> Trace[R]:
        """Shape-correct all-zeros trace (no FLOPs, no sampling)."""
        from genjax_xla.core.compiler.staging import empty_trace

        return empty_trace(self, args)

    def __abstract_call__(self, *args) -> R:
        """Return-value shape evaluation used when tracing ``@gen`` bodies."""
        key = jax.random.key(0)
        return self.simulate(key, args).get_retval()

    # -- callable sugar ---------------------------------------------------

    def __call__(self, *args, **kwargs) -> "GenerativeFunctionClosure[R]":
        return GenerativeFunctionClosure(self, args, kwargs)

    def handle_kwargs(self) -> "GenerativeFunction[R]":
        """Return a version taking ``(args_tuple, kwargs_dict)`` as its
        argument pair. Default: kwargs are ignored (distributions and
        combinators have positional-only interfaces); ``Fn`` overrides to
        actually apply them. Parity: reference
        ``generative_function.py:303-339, 1487-1550``."""
        return IgnoreKwargs(self)

    # -- combinator postfix methods ---------------------------------------
    # Each lazily imports its combinator; parity with reference
    # ``generative_function.py:700-1486``.

    def vmap(self, *, in_axes=0, axis_size=None, axis_name=None):
        from genjax_xla.core.argcheck import check_in_axes
        from genjax_xla.lang.combinators.vmap import Vmap

        check_in_axes(in_axes, "GenerativeFunction.vmap")
        return Vmap(self, in_axes=in_axes, axis_size=axis_size,
                    axis_name=axis_name)

    def repeat(self, *, n: int):
        from genjax_xla.core.argcheck import check_static_int
        from genjax_xla.lang.combinators.repeat import repeat

        check_static_int(n, "repeat(n=...)")
        return repeat(n=n)(self)

    def scan(self, *, n: int | None = None):
        from genjax_xla.lang.combinators.scan import Scan

        return Scan(self, length=n)

    def accumulate(self):
        from genjax_xla.lang.combinators.scan import accumulate

        return accumulate()(self)

    def reduce(self):
        from genjax_xla.lang.combinators.scan import reduce

        return reduce()(self)

    def iterate(self, *, n: int):
        from genjax_xla.core.argcheck import check_static_int
        from genjax_xla.lang.combinators.scan import iterate

        check_static_int(n, "iterate(n=...)")
        return iterate(n=n)(self)

    def iterate_final(self, *, n: int):
        from genjax_xla.core.argcheck import check_static_int
        from genjax_xla.lang.combinators.scan import iterate_final

        check_static_int(n, "iterate_final(n=...)")
        return iterate_final(n=n)(self)

    def masked_iterate(self):
        from genjax_xla.lang.combinators.scan import masked_iterate

        return masked_iterate()(self)

    def masked_iterate_final(self):
        from genjax_xla.lang.combinators.scan import masked_iterate_final

        return masked_iterate_final()(self)

    def mask(self):
        from genjax_xla.lang.combinators.mask import MaskCombinator

        return MaskCombinator(self)

    def or_else(self, gen_fn: "GenerativeFunction[R]"):
        from genjax_xla.core.argcheck import check_gen_fn
        from genjax_xla.lang.combinators.or_else import OrElse

        check_gen_fn(gen_fn, "or_else")
        return OrElse(self, gen_fn)

    def switch(self, *branches: "GenerativeFunction[R]"):
        from genjax_xla.core.argcheck import check_gen_fns
        from genjax_xla.lang.combinators.switch import Switch

        check_gen_fns((self, *branches), "switch")
        return Switch((self, *branches))

    def mix(self, *fns: "GenerativeFunction[R]"):
        from genjax_xla.core.argcheck import check_gen_fns
        from genjax_xla.lang.combinators.mixture import mix

        check_gen_fns((self, *fns), "mix")
        return mix(self, *fns)

    def dimap(self, *, pre=None, post=None):
        from genjax_xla.core.argcheck import check_callable
        from genjax_xla.lang.combinators.dimap import Dimap

        if pre is not None:
            check_callable(pre, "dimap(pre=...)")
        if post is not None:
            check_callable(post, "dimap(post=...)")
        return Dimap(
            self,
            pre=pre if pre is not None else lambda *a: a,
            post=post if post is not None else lambda args, r: r,
        )

    def map(self, post: Callable):
        return self.dimap(post=lambda args, r: post(r))

    def contramap(self, pre: Callable):
        return self.dimap(pre=pre)

    def marginal(self, *, selection: Selection | None = None, algorithm=None):
        from genjax_xla.inference.sp import Marginal

        if selection is not None and not isinstance(selection, Selection):
            raise TypeError(
                "marginal(selection=...) expects a Selection, got "
                f"{type(selection).__name__}: {selection!r}."
            )
        sel = selection if selection is not None else Selection.all()
        return Marginal(self, Pytree.const(sel), algorithm)


@Pytree.dataclass
class IgnoreKwargs(GenerativeFunction[Any]):
    """Adapter: (args, kwargs_dict) tuple calling convention.

    Parity: reference ``generative_function.py:1487-1550``."""

    wrapped: GenerativeFunction[Any]

    def simulate(self, key, args):
        (a, _kwargs) = args
        return self.wrapped.simulate(key, a)

    def assess(self, chm, args):
        (a, _kwargs) = args
        return self.wrapped.assess(chm, a)

    def generate(self, key, constraint, args):
        (a, _kwargs) = args
        return self.wrapped.generate(key, constraint, a)

    def project(self, key, trace, selection):
        return self.wrapped.project(key, trace, selection)

    def edit(self, key, trace, request, argdiffs):
        (a_diffs, _kwargs) = argdiffs
        return self.wrapped.edit(key, trace, request, a_diffs)


@Pytree.dataclass
class GenerativeFunctionClosure(Pytree, Generic[R]):
    """``gf(args)`` — a gen fn partially applied to arguments. Inside a
    ``@gen`` body, ``closure @ "addr"`` records a traced call at ``addr``.

    Parity: reference ``generative_function.py:1557-1684``.
    """

    gen_fn: GenerativeFunction[R]
    args: tuple
    kwargs: dict = Pytree.field(default_factory=dict)

    def _resolve(self) -> tuple:
        """Fold kwargs into a concrete (gen_fn, args) pair: named
        distribution parameters bind positionally, ``sample_shape``
        builds an iid block, anything left routes through
        ``handle_kwargs`` ((args, kwargs) calling convention)."""
        from genjax_xla.core.pytree import Const

        if not self.kwargs:
            return self.gen_fn, self.args
        kw = dict(self.kwargs)
        ss = kw.pop("sample_shape", None)
        gf, args = self.gen_fn, self.args
        if kw and hasattr(gf, "bind_kwargs"):
            # Named distribution parameters — ``normal(loc=0.,
            # scale=1.)`` — resolved to positional args at trace time
            # (parity: reference TFP kwargs).
            args = gf.bind_kwargs(args, kw)
            kw = {}
        if ss is not None and hasattr(gf, "iid"):
            # ``normal(0., 1., sample_shape=Const((2, 2)))``: an iid
            # block with a static leading shape (parity: reference
            # TFP sample_shape).
            shape = ss.value if isinstance(ss, Const) else ss
            gf, ss = gf.iid(shape), None
        if ss is not None:
            kw["sample_shape"] = ss
        if kw:
            return gf.handle_kwargs(), (args, kw)
        return gf, args

    def __matmul__(self, addr) -> R:
        from genjax_xla.lang.static import trace_here

        gf, args = self._resolve()
        return trace_here(addr, gf, args)

    # Direct GFI passthrough on the closed-over args (kwargs resolved
    # identically to the ``@ addr`` path — a closure with kwargs used
    # to silently drop them here).

    def simulate(self, key):
        gf, args = self._resolve()
        return gf.simulate(key, args)

    def assess(self, chm):
        gf, args = self._resolve()
        return gf.assess(chm, args)

    def generate(self, key, constraint):
        gf, args = self._resolve()
        return gf.generate(key, constraint, args)

    def project(self, key, trace, selection):
        gf, _args = self._resolve()
        return gf.project(key, trace, selection)

    def edit(self, key, trace, request, argdiffs):
        gf, _args = self._resolve()
        return gf.edit(key, trace, request, argdiffs)
