"""Mixture model families."""

from __future__ import annotations

import jax.numpy as jnp

from genjax_xla.lang.static import gen
from genjax_xla.lang.distributions import categorical, normal

__all__ = ["gaussian_mixture"]


def gaussian_mixture(n_components: int):
    """K-component 1-D Gaussian mixture with a categorical assignment per
    draw; addresses "comp" and "x". Args: (logits, locs, scales)."""

    @gen
    def mixture(logits, locs, scales):
        comp = categorical(logits) @ "comp"
        x = normal(locs[comp], scales[comp]) @ "x"
        return x

    return mixture
