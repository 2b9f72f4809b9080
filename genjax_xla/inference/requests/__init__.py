"""MCMC moves as edit requests."""

from genjax_xla.inference.requests.ess import (
    EllipticalSlice,
    elliptical_slice_kernel,
)
from genjax_xla.inference.requests.hmc import HMC, SafeHMC, selection_gradient
from genjax_xla.inference.requests.mala import MALA
from genjax_xla.inference.requests.rejuvenate import Rejuvenate

__all__ = ["EllipticalSlice", "HMC", "MALA", "Rejuvenate", "SafeHMC",
           "elliptical_slice_kernel", "selection_gradient"]
