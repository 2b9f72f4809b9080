"""Distributions: the stochastic-probability interface and the standard
library of exact-density distributions (no TFP dependency)."""

from genjax_xla.lang.distributions.distribution import (
    Distribution,
    DistributionTrace,
    ExactDensity,
    exact_density,
)
from genjax_xla.lang.distributions.stdlib import *  # noqa: F401,F403
from genjax_xla.lang.distributions.stdlib import __all__ as _stdlib_all
from genjax_xla.lang.distributions.discrete_hmm import (
    DiscreteHMM,
    DiscreteHMMConfiguration,
    discrete_hmm,
)

__all__ = [
    "DiscreteHMM",
    "DiscreteHMMConfiguration",
    "Distribution",
    "DistributionTrace",
    "ExactDensity",
    "discrete_hmm",
    "exact_density",
    *_stdlib_all,
]
