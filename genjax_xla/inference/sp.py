"""GenSP: stochastic-probability interface for inference algorithms.

Inference algorithms ARE distributions over choice maps (Lew et al. 2023):
``Target`` packages an unnormalized posterior; ``Algorithm`` is a
``Distribution[ChoiceMap]`` with normalizing-constant estimators that power
variational objectives.

Parity target: ``/root/reference/src/genjax/_src/inference/sp.py``
(``Target`` :52-94, ``SampleDistribution``/``Algorithm`` :101-199,
``Marginal``/``marginal`` :207-273).
"""

from __future__ import annotations

import abc
from typing import Callable

import jax
import jax.numpy as jnp

from genjax_xla.core.pytree import Const, Pytree
from genjax_xla.gfi.choice_map import ChoiceMap
from genjax_xla.gfi.concepts import Score, Weight
from genjax_xla.gfi.gfn import GenerativeFunction, Trace
from genjax_xla.gfi.selection import Selection
from genjax_xla.lang.distributions.distribution import (
    Distribution,
    DistributionTrace,
)

__all__ = [
    "Target",
    "SampleDistribution",
    "Algorithm",
    "Marginal",
    "marginal",
]


@Pytree.dataclass
class Target(Pytree):
    """An unnormalized target measure: generative function + arguments +
    constraint. The posterior is over the unconstrained choices.

    Parity: reference ``sp.py:52-94``."""

    p: GenerativeFunction
    args: tuple
    constraint: ChoiceMap

    def __post_init__(self):
        # A Marginal's density is itself estimated — using one as a
        # Target's model would silently nest estimators with the wrong
        # weight semantics (parity: reference ``sp.py:46-49`` raises at
        # construction; ``test_smc.py test_non_marginal_target``).
        if isinstance(self.p, Marginal):
            raise TypeError(
                "Target does not accept Marginal models; target the "
                "underlying generative function and constrain/select "
                "its addresses instead."
            )

    def importance(self, key: jax.Array, chm: ChoiceMap) -> tuple[Trace, Weight]:
        """Generate from ``p`` under the merged constraint."""
        merged = self.constraint | chm
        return self.p.generate(key, merged, self.args)

    def filter_to_unconstrained(self, chm: ChoiceMap) -> ChoiceMap:
        """Strip the constrained addresses from ``chm``."""
        selection = ~self.constraint.get_selection()
        return chm.filter(selection)

    def __getitem__(self, addr):
        return self.constraint[addr]


class SampleDistribution(Distribution):
    """A distribution whose values are choice maps — ``random_weighted``
    returns an *unbiased density-reciprocal estimate* together with the
    sample, and ``estimate_logpdf`` an unbiased density estimate (Lew et
    al. 2023, defns 3.1 / 3.2). Parity: reference ``sp.py:101-140``."""

    # Values are ChoiceMaps: a nested constraint at a SampleDistribution
    # site (C["site"].set(C[...].set(v))) IS the value.
    chm_valued = True


class Algorithm(SampleDistribution):
    """An approximate-inference strategy for a :class:`Target`, usable as a
    proposal or marginal inside other models. Parity: reference
    ``sp.py:143-199``."""

    @abc.abstractmethod
    def random_weighted(self, key: jax.Array, target: Target): ...

    @abc.abstractmethod
    def estimate_logpdf(self, key: jax.Array, chm: ChoiceMap,
                        target: Target) -> Score: ...

    # -- VI hooks ---------------------------------------------------------

    @abc.abstractmethod
    def estimate_normalizing_constant(self, key: jax.Array,
                                      target: Target) -> Weight: ...

    @abc.abstractmethod
    def estimate_reciprocal_normalizing_constant(
        self, key: jax.Array, target: Target, latent_choices: ChoiceMap,
        w: Weight,
    ) -> Weight: ...

    def estimate_marginal_density(
        self, key: jax.Array, target: Target, latent_choices: ChoiceMap,
        w: Weight,
    ) -> Weight:
        """+logẐ of the target's constraint given the properly-weighted
        retained pair — the negation of the reciprocal estimate by
        default (SMC algorithms override with a fused computation)."""
        return -self.estimate_reciprocal_normalizing_constant(
            key, target, latent_choices, w
        )


@Pytree.dataclass
class Marginal(SampleDistribution):
    """The marginal distribution of a generative function over the
    addresses picked out by ``selection``; non-selected choices are
    marginalized with ``algorithm`` (default: importance with the prior).

    Parity: reference ``sp.py:207-252``."""

    gen_fn: GenerativeFunction
    selection: Const
    algorithm: "Algorithm | None" = None

    def random_weighted(self, key: jax.Array, *args):
        from genjax_xla.inference.smc import Importance

        key, sub_key, proj_key = jax.random.split(key, 3)
        tr = self.gen_fn.simulate(key, args)
        choices = tr.get_choices()
        selection = self.selection.value
        latent = choices.filter(selection)
        other = choices.filter(~selection)
        target = Target(self.gen_fn, args, latent)
        alg = self.algorithm or Importance(target)
        # The retained pair (other, w) must be PROPERLY weighted for the
        # conditional target: w = joint − ancestral-prior(other)
        # = project(selection) — not the raw full score (which the
        # reference passes, `sp.py:231`, making weights degenerate when
        # nothing is marginalized).
        w_proper = tr.project(proj_key, selection)
        log_density_est = alg.estimate_marginal_density(
            sub_key, target, other, w_proper
        )
        return log_density_est, latent

    def estimate_logpdf(self, key: jax.Array, latent: ChoiceMap, *args):
        from genjax_xla.inference.smc import Importance

        target = Target(self.gen_fn, args, latent)
        alg = self.algorithm or Importance(target)
        z = alg.estimate_normalizing_constant(key, target)
        return z


def marginal(selection: Selection | None = None,
             algorithm: "Algorithm | None" = None) -> Callable:
    """Decorator form: ``@marginal(selection=...)`` on a gen fn.

    Parity: reference ``sp.py:260-273``."""

    def decorator(gen_fn: GenerativeFunction) -> Marginal:
        sel = selection if selection is not None else Selection.all()
        return Marginal(gen_fn, Pytree.const(sel), algorithm)

    return decorator
