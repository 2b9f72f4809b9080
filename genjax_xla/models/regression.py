"""Regression model families."""

from __future__ import annotations

import jax.numpy as jnp

from genjax_xla.lang.static import gen
from genjax_xla.lang.distributions import mv_normal_diag, normal

__all__ = ["hierarchical_regression"]


def hierarchical_regression():
    """Bayesian linear regression with learned noise (unconstrained
    log-sigma parameterization — NUTS-ready):
    addresses: "slope", "icept", "log_sigma", "ys"."""

    @gen
    def regression(xs):
        slope = normal(0.0, 2.0) @ "slope"
        icept = normal(0.0, 2.0) @ "icept"
        log_sigma = normal(-1.0, 0.7) @ "log_sigma"
        sigma = jnp.exp(log_sigma)
        _ = mv_normal_diag(
            slope * xs + icept, sigma * jnp.ones_like(xs)
        ) @ "ys"

    return regression
