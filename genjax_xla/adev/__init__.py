"""ADEV: automatic differentiation of expected values."""

from genjax_xla.adev.core import (
    ADEVPrimitive,
    TailCallADEVPrimitive,
    ADEVProgram,
    Dual,
    Expectation,
    expectation,
    sample_p,
    sample_primitive,
)
from genjax_xla.adev.primitives import *  # noqa: F401,F403
from genjax_xla.adev.primitives import __all__ as _prims_all

__all__ = [
    "ADEVPrimitive",
    "ADEVProgram",
    "TailCallADEVPrimitive",
    "Dual",
    "Expectation",
    "expectation",
    "sample_p",
    "sample_primitive",
    *_prims_all,
]
