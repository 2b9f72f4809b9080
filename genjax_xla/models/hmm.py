"""Discrete-HMM generative model (the sampled counterpart of the exact
``DiscreteHMM`` posterior oracle)."""

from __future__ import annotations

import jax
import jax.numpy as jnp

from genjax_xla.lang.static import gen
from genjax_xla.lang.distributions import categorical
from genjax_xla.lang.distributions.discrete_hmm import (
    DiscreteHMMConfiguration,
)

__all__ = ["hmm_model", "hmm_bootstrap_filter"]


def hmm_model(config: DiscreteHMMConfiguration, n_steps: int):
    """Scanned HMM gen fn: latents at ``("chain", t, "z")`` (plus "z0"),
    observations at ``("chain", t, "x")`` (plus "x0")."""

    @gen
    def step(z, _):
        z_next = categorical(config.transition_logits[z]) @ "z"
        _ = categorical(config.observation_logits[z_next]) @ "x"
        return z_next, z_next

    @gen
    def hmm():
        z0 = categorical(config.prior_logits) @ "z0"
        _ = categorical(config.observation_logits[z0]) @ "x0"
        _ = step.scan(n=n_steps - 1)(z0, None) @ "chain"

    return hmm


def hmm_bootstrap_filter(config: DiscreteHMMConfiguration,
                         n_particles: int, sampling: str = "invcdf",
                         **pf_kwargs):
    """Bootstrap particle filter for a discrete HMM:
    ``run(key, observations) -> (FilterState, log_z_per_step)``.

    The whole ensemble advances at once, with one key per step
    (``batched=True`` path of :func:`~genjax_xla.inference.pf
    .particle_filter`); each particle's transition row and emission
    score are gathered from the tables by its state. ``sampling``:

    - ``"invcdf"`` (default): transitions sampled by inverse CDF — the
      new state is a compare-count of the particle's transition-CDF row
      against ONE uniform per particle. Exactly the transition
      distribution (to f32 CDF roundoff), with no P×S gumbel field and
      no argmax.
    - ``"gumbel"``: ``jax.random.categorical`` on the gathered logits
      rows (different random stream, same law).

    ``observations`` is the full ``(T,)`` int sequence; the first
    entry conditions the init."""

    from genjax_xla.inference.pf import particle_filter

    if sampling not in ("invcdf", "gumbel"):
        raise ValueError(f"unknown sampling scheme {sampling!r}")
    s_states = config.transition_logits.shape[0]
    # Inverse-CDF table. The count z = #{j : cdf_j < u} is clipped to
    # S-1 below: f32 cumsum roundoff can leave cdf[-1] < 1, and the
    # deficit folds into the last bucket.
    trans_cdf = jnp.cumsum(
        jax.nn.softmax(config.transition_logits, axis=-1), axis=-1
    )
    obs_logits = config.observation_logits

    def make(observations):
        def init(key):
            z = jax.random.categorical(
                key, config.prior_logits, shape=(n_particles,)
            )
            return z, obs_logits[z, observations[0]]

        def step_gumbel(key, zs, o):
            z_new = jax.random.categorical(
                key, config.transition_logits[zs], axis=-1
            )
            return z_new, obs_logits[z_new, o]

        def step_invcdf(key, zs, o):
            u = jax.random.uniform(key, (n_particles, 1))
            z_new = jnp.minimum(
                jnp.sum(trans_cdf[zs] < u, axis=-1), s_states - 1
            ).astype(zs.dtype)
            return z_new, obs_logits[z_new, o]

        step = step_invcdf if sampling == "invcdf" else step_gumbel
        return particle_filter(
            init, step, n_particles, batched=True, **pf_kwargs
        )

    def run(key, observations):
        return make(observations)(key, observations[1:])

    return run
