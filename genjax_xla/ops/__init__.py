"""Kernel-level operations shared by the inference and model layers."""

from genjax_xla.ops.logmatmul import log_matmul
from genjax_xla.ops.mxu import mxu_dot

__all__ = ["log_matmul", "mxu_dot"]
