"""Exact-inference testbed: generate HMM inference problems with exact
log-posteriors / log-marginals to validate approximate algorithms.

Parity target: ``/root/reference/src/genjax/_src/inference/exact_testbed.py``
(``DiscreteHMMInferenceProblem`` :36, ``build_test_against_exact_inference``
:45-91).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from genjax_xla.core.pytree import Pytree
from genjax_xla.lang.distributions.discrete_hmm import (
    DiscreteHMMConfiguration,
    forward_filter,
    joint_logpdf,
)

__all__ = ["DiscreteHMMInferenceProblem", "build_test_against_exact_inference"]


@Pytree.dataclass
class DiscreteHMMInferenceProblem(Pytree):
    """An HMM posterior-inference problem with its exact answers."""

    config: DiscreteHMMConfiguration
    observations: jax.Array
    latents: jax.Array
    log_data_marginal: jax.Array

    def exact_posterior_logpdf(self, z: jax.Array) -> jax.Array:
        return (
            joint_logpdf(self.config, z, self.observations)
            - self.log_data_marginal
        )


def sample_problem(key: jax.Array, config: DiscreteHMMConfiguration,
                   num_steps: int) -> DiscreteHMMInferenceProblem:
    """Forward-sample latents + observations, then compute exact answers."""
    k_z0, k_scan = jax.random.split(key)
    z0 = jax.random.categorical(k_z0, config.prior_logits)

    def step(z, i):
        kz = jax.random.fold_in(k_scan, 2 * i)
        kx = jax.random.fold_in(k_scan, 2 * i + 1)
        x = jax.random.categorical(kx, config.observation_logits[z])
        z_next = jax.random.categorical(kz, config.transition_logits[z])
        return z_next, (z, x)

    _, (zs, xs) = jax.lax.scan(step, z0, jnp.arange(num_steps))
    _, logm = forward_filter(config, xs)
    return DiscreteHMMInferenceProblem(config, xs, zs, logm)


def build_test_against_exact_inference(
    num_states: int = 5,
    num_obs: int = 5,
    num_steps: int = 10,
) -> Callable[[jax.Array], DiscreteHMMInferenceProblem]:
    """Returns ``key -> DiscreteHMMInferenceProblem`` with circulant
    structure matching the reference testbed."""
    config = DiscreteHMMConfiguration.circulant(num_states, num_obs)

    def build(key: jax.Array) -> DiscreteHMMInferenceProblem:
        return sample_problem(key, config, num_steps)

    return build
