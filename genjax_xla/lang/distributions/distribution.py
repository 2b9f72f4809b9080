"""``Distribution`` — generative functions over a single random choice, built
on the stochastic-probability interface (``random_weighted`` /
``estimate_logpdf``), and ``ExactDensity`` for distributions with tractable
log-densities.

Parity target: ``/root/reference/src/genjax/_src/generative_functions/
distributions/distribution.py`` (``Distribution`` :90, ``ExactDensity`` :359,
``exact_density`` :436, constraint handling :117-147, update arithmetic
:179-244, regenerate :258-300, ``project`` :246).

Design difference: masked constraints are resolved by *unconditional
sample + select* (``jnp.where``) instead of ``lax.cond`` — under ``vmap`` both
branches of a ``cond`` execute anyway, and the select fuses into the
surrounding program with no control-flow overhead.
"""

from __future__ import annotations

import abc
from typing import Any, Callable

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
from jax.experimental import checkify

from genjax_xla.core.checks import optional_check
from genjax_xla.core.pytree import Pytree
from genjax_xla.core.compiler.staging import FlagOp
from genjax_xla.core.compiler.interpreters.incremental import Diff
from genjax_xla.gfi.choice_map import ChoiceMap
from genjax_xla.gfi.concepts import Argdiffs, EditRequest, Score, Weight
from genjax_xla.gfi.gfn import GenerativeFunction, Trace
from genjax_xla.gfi.mask import Mask
from genjax_xla.gfi.requests import Regenerate, Update
from genjax_xla.gfi.selection import Selection

__all__ = [
    "Distribution",
    "DistributionTrace",
    "ExactDensity",
    "exact_density",
]


@Pytree.dataclass
class DistributionTrace(Trace[Any]):
    """Trace of a single-choice distribution. Parity: reference
    ``distribution.py:59-88``."""

    gen_fn: "Distribution"
    args: tuple
    value: Any
    score: Score

    def get_args(self) -> tuple:
        return self.args

    def get_retval(self):
        return self.value

    def get_score(self) -> Score:
        return self.score

    def get_gen_fn(self):
        return self.gen_fn

    def get_choices(self) -> ChoiceMap:
        return ChoiceMap.choice(self.value)


def _tree_where(flag, a, b):
    """Leafwise select, broadcasting ``flag`` against leading dims."""
    def sel(x, y):
        x = jnp.asarray(x)
        f = jnp.asarray(flag)
        f = jnp.reshape(f, f.shape + (1,) * (x.ndim - f.ndim))
        return jnp.where(f, x, y)

    if flag is True:
        return a
    if flag is False:
        return b
    return jtu.tree_map(sel, a, b)


class Distribution(GenerativeFunction[Any]):
    """A generative function with one anonymous choice, specified by:

    - ``random_weighted(key, *args) -> (score_estimate, value)`` — sample
      ``v ~ p(.; args)`` and return an unbiased estimate of
      ``log p(v; args)``;
    - ``estimate_logpdf(key, v, *args) -> score_estimate``.

    (Lew et al. 2023, defns 3.1/3.2 — reference ``distribution.py:90-115``.)
    """

    #: True for distributions whose *value space is itself a ChoiceMap*
    #: (e.g. ``inference.sp.SampleDistribution`` — marginals, algorithms).
    #: Users naturally constrain such sites with a *nested* map
    #: (``C["site"].set(C["value"].set(v))``), which arrives here as a
    #: valueless submap; when this flag is set, the whole submap is the
    #: constrained value.
    chm_valued: bool = False

    @abc.abstractmethod
    def random_weighted(self, key: jax.Array, *args) -> tuple[Score, Any]: ...

    @abc.abstractmethod
    def estimate_logpdf(self, key: jax.Array, v: Any, *args) -> Score: ...

    def _constraint_value(self, constraint: ChoiceMap):
        """The constrained value at this site, or None if unconstrained."""
        cv = constraint.get_value()
        if cv is None and self.chm_valued and not constraint.static_is_empty():
            return constraint
        return cv

    def get_support(self, *args):
        """Support metadata for gradient-based samplers (automatic
        bijector selection — see ``inference/transforms.py``): ``None``
        (real line / unknown), ``"positive"``, ``"unit_interval"``,
        ``"simplex"``, or an ``(low, high)`` tuple. New scope vs the
        reference (no support metadata there)."""
        return None

    # -- GFI --------------------------------------------------------------

    def simulate(self, key: jax.Array, args: tuple) -> DistributionTrace:
        score, v = self.random_weighted(key, *args)
        return DistributionTrace(self, args, v, score)

    def assess(self, chm: ChoiceMap, args: tuple):
        v = self._constraint_value(chm)
        if v is None:
            raise ValueError(
                f"{self}: assess requires a value choice at the root."
            )
        if isinstance(v, Mask):
            def check():
                checkify.check(
                    jnp.all(jnp.asarray(v.flag)),
                    "assess on a Mask with flag False",
                )
            optional_check(check)
            v = v.value
        # The GFI's assess is keyless (reference distribution.py:398):
        # exact densities ignore the key entirely; stochastic-density
        # subclasses receive a FIXED key here, i.e. one deterministic
        # realization of the density estimator — use estimate_logpdf
        # directly when fresh estimator randomness matters.
        key = jax.random.key(0)
        score = self.estimate_logpdf(key, v, *args)
        return score, v

    def generate(self, key: jax.Array, constraint: ChoiceMap, args: tuple):
        cv = self._constraint_value(constraint)
        if cv is None:
            tr = self.simulate(key, args)
            return tr, jnp.zeros(())
        if isinstance(cv, Mask):
            flag = cv.primal_flag()
            if FlagOp.concrete_true(flag):
                cv = cv.value
            elif FlagOp.concrete_false(flag):
                tr = self.simulate(key, args)
                return tr, jnp.zeros(())
            else:
                # Traced flag: sample unconditionally, select, rescore.
                key, est_key = jax.random.split(key)
                _, sampled = self.random_weighted(key, *args)
                v = _tree_where(flag, cv.value, sampled)
                score = self.estimate_logpdf(est_key, v, *args)
                w = jnp.where(flag, score, jnp.zeros(()))
                return DistributionTrace(self, args, v, score), w
        score = self.estimate_logpdf(key, cv, *args)
        return DistributionTrace(self, args, cv, score), score

    def project(self, key: jax.Array, trace: DistributionTrace,
                selection: Selection) -> Weight:
        flag = selection.check()
        if FlagOp.concrete_true(flag):
            return trace.get_score()
        if FlagOp.concrete_false(flag):
            return jnp.zeros(())
        return jnp.where(flag, trace.get_score(), jnp.zeros(()))

    def edit(self, key: jax.Array, trace: DistributionTrace,
             request: EditRequest, argdiffs: Argdiffs):
        args = Diff.tree_primal(argdiffs)
        no_change = Diff.static_check_no_change(argdiffs)
        if isinstance(request, Update):
            return self._edit_update(key, trace, request.constraint, args,
                                     no_change)
        if isinstance(request, Regenerate):
            return self._edit_regenerate(key, trace, request.selection, args,
                                         no_change)
        raise NotImplementedError(
            f"{type(self).__name__} does not support "
            f"{type(request).__name__}"
        )

    def _edit_update(self, key, trace, constraint: ChoiceMap, args,
                     args_unchanged: bool):
        """SMCP3 update arithmetic. Parity: reference
        ``distribution.py:179-244``."""
        old_v = trace.get_retval()
        old_score = trace.get_score()
        cv = self._constraint_value(constraint)

        if cv is None:
            if args_unchanged:
                retdiff = Diff.no_change(old_v)
                return trace, jnp.zeros(()), retdiff, Update(ChoiceMap.empty())
            new_score = self.estimate_logpdf(key, old_v, *args)
            new_tr = DistributionTrace(self, args, old_v, new_score)
            return (new_tr, new_score - old_score, Diff.no_change(old_v),
                    Update(ChoiceMap.empty()))

        if isinstance(cv, Mask):
            flag = cv.primal_flag()
            if FlagOp.concrete_true(flag):
                cv = cv.value
            elif FlagOp.concrete_false(flag):
                return self._edit_update(key, trace, ChoiceMap.empty(), args,
                                         args_unchanged)
            else:
                v = _tree_where(flag, cv.value, old_v)
                new_score = self.estimate_logpdf(key, v, *args)
                new_tr = DistributionTrace(self, args, v, new_score)
                w = new_score - old_score
                discard = ChoiceMap.choice(Mask.build(old_v, flag))
                return new_tr, w, Diff.unknown_change(v), Update(discard)

        new_score = self.estimate_logpdf(key, cv, *args)
        new_tr = DistributionTrace(self, args, cv, new_score)
        w = new_score - old_score
        return (new_tr, w, Diff.unknown_change(cv),
                Update(ChoiceMap.choice(old_v)))

    def _edit_regenerate(self, key, trace, selection: Selection, args,
                         args_unchanged: bool):
        """Parity: reference ``distribution.py:258-300``. When selected, the
        forward proposal is the prior at the new args, so the incremental
        weight is exactly 0; when not selected, the choice is retained and
        rescored."""
        old_v = trace.get_retval()
        old_score = trace.get_score()
        flag = selection.check()

        if FlagOp.concrete_false(flag):
            return self._edit_update(key, trace, ChoiceMap.empty(), args,
                                     args_unchanged)
        if FlagOp.concrete_true(flag):
            new_score, v = self.random_weighted(key, *args)
            new_tr = DistributionTrace(self, args, v, new_score)
            return (new_tr, jnp.zeros(()), Diff.unknown_change(v),
                    Regenerate(selection))
        # Traced flag: sample + select.
        key, est_key = jax.random.split(key)
        _, sampled = self.random_weighted(key, *args)
        v = _tree_where(flag, sampled, old_v)
        new_score = self.estimate_logpdf(est_key, v, *args)
        new_tr = DistributionTrace(self, args, v, new_score)
        w = jnp.where(flag, jnp.zeros(()), new_score - old_score)
        return new_tr, w, Diff.unknown_change(v), Regenerate(selection)


class ExactDensity(Distribution):
    """Distribution with exactly computable log-density: specify
    ``sample(key, *args)`` and ``logpdf(v, *args)``.

    Parity: reference ``distribution.py:359-433``. Log-densities with
    residual (non-event) batch dimensions are summed, treating them as
    products of independent draws (reference ``distribution.py:383-396``).
    """

    @abc.abstractmethod
    def sample(self, key: jax.Array, *args) -> Any: ...

    @abc.abstractmethod
    def logpdf(self, v: Any, *args) -> Score: ...

    def random_weighted(self, key, *args):
        v = self.sample(key, *args)
        return self._logpdf_sum(v, *args), v

    def estimate_logpdf(self, key, v, *args):
        return self._logpdf_sum(v, *args)

    def _logpdf_sum(self, v, *args) -> Score:
        lp = self.logpdf(v, *args)
        if jnp.ndim(lp) > 0:
            return jnp.sum(lp)
        return lp

    def bind_kwargs(self, args: tuple, kwargs: dict) -> tuple:
        """Resolve named distribution parameters to positional args —
        ``normal(loc=0., scale=1.)``, ``categorical(probs=[...])`` —
        using the sampler's parameter names plus per-distribution
        aliases (parity: reference TFP kwargs,
        ``tests/.../test_distributions.py test_distribution_kwargs``)."""
        import inspect

        kw = dict(kwargs)
        for name, (target, conv) in (self.kwarg_aliases() or {}).items():
            if name in kw:
                if target in kw:
                    raise TypeError(
                        f"{self!r}: both '{name}' and '{target}' given"
                    )
                kw[target] = conv(kw.pop(name))
        fn = getattr(self, "sampler", None) or self.sample
        try:
            params = [
                p.name
                for p in inspect.signature(fn).parameters.values()
                if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
            ][1:]  # drop the key
        except (TypeError, ValueError):
            params = []
        if not params and kw:
            raise TypeError(
                f"{self!r} takes no named parameters, got {list(kw)}"
            )
        bound = []
        for i, p in enumerate(params):
            if i < len(args):
                if p in kw:
                    raise TypeError(
                        f"{self!r}: '{p}' given positionally and by name"
                    )
                bound.append(args[i])
            elif p in kw:
                bound.append(kw.pop(p))
            else:
                raise TypeError(f"{self!r}: missing parameter '{p}'")
        if kw:
            raise TypeError(f"{self!r}: unknown parameters {list(kw)}")
        return tuple(bound)

    def kwarg_aliases(self) -> dict:
        """Optional ``{alias: (param, converter)}`` map — e.g.
        categorical's ``probs -> logits`` via log."""
        return getattr(self, "aliases", None) or {}

    def iid(self, sample_shape) -> "IIDBlock":
        """An iid block of this distribution with a STATIC leading
        ``sample_shape``: the score is the joint (summed) log-density.
        Reached from ``@gen`` via the ``sample_shape=`` kwarg — e.g.
        ``normal(0., 1., sample_shape=Const((2, 2))) @ "x"`` (parity:
        reference TFP ``sample_shape``,
        ``tests/.../test_static_gen_fn.py test_static_sample_shape``)."""
        if isinstance(sample_shape, int):
            sample_shape = (sample_shape,)
        return IIDBlock(self, tuple(int(s) for s in sample_shape))


@Pytree.dataclass
class IIDBlock(ExactDensity):
    """``sample_shape`` iid draws of an inner :class:`ExactDensity` as
    one choice: value shape ``sample_shape + event_shape``, score the
    summed log-density. The per-draw keys come from one ``vmap`` over
    split keys, so the block stays a single batched threefry launch."""

    inner: ExactDensity
    shape: tuple = Pytree.static()

    def _n(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    def sample(self, key, *args):
        ks = jax.random.split(key, self._n())
        draws = jax.vmap(lambda k: self.inner.sample(k, *args))(ks)
        return draws.reshape(self.shape + draws.shape[1:])

    def logpdf(self, v, *args):
        nd = len(self.shape)
        flat = jnp.reshape(v, (self._n(),) + jnp.shape(v)[nd:])
        return jax.vmap(lambda x: self.inner._logpdf_sum(x, *args))(flat)

    def get_support(self, *args):
        getter = getattr(self.inner, "get_support", None)
        return getter(*args) if getter is not None else None

    def __repr__(self):
        return f"{self.inner!r}.iid({self.shape})"


@Pytree.dataclass
class ExactDensityFromCallables(ExactDensity):
    """An :class:`ExactDensity` from a (sampler, logpdf) pair of callables."""

    sampler: Callable = Pytree.static()
    logpdf_fn: Callable = Pytree.static()
    name: str = Pytree.static(default="exact_density")
    support: Any = Pytree.static(default=None)
    aliases: Any = Pytree.static(default=None)

    def sample(self, key, *args):
        return self.sampler(key, *args)

    def logpdf(self, v, *args):
        return self.logpdf_fn(v, *args)

    def get_support(self, *args):
        # A callable spec derives the support from the distribution args
        # (e.g. uniform: ``lambda low, high: (low, high)``).
        if callable(self.support):
            return self.support(*args)
        return self.support

    def __repr__(self):
        return f"genjax_xla.{self.name}"


def exact_density(sample: Callable, logpdf: Callable,
                  name: str = "exact_density",
                  support: Any = None,
                  aliases: Any = None) -> ExactDensityFromCallables:
    """Build an :class:`ExactDensity` from a sampler and a log-density.
    ``support`` (optional) is the support spec for automatic bijector
    selection — a string/tuple or a callable of the distribution args.
    ``aliases`` (optional) maps alternative parameter names to
    ``(param, converter)`` pairs for named-kwarg calls.

    Parity: reference ``distribution.py:436-476``."""
    return ExactDensityFromCallables(sample, logpdf, name, support,
                                     aliases)
