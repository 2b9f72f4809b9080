"""Sequential Monte Carlo over time (particle filtering): initialize a
particle ensemble from a prior generative function, then alternate
extend-with-observation / reweight / adaptive-resample steps inside one
``lax.scan``. The particle axis is a vmap axis throughout — it shards over
a device mesh unchanged (benchmark config 4: 1M-particle nonlinear
tracking).

New scope relative to the reference: its SMC library (``smc.py``) has no
sequential filtering driver and no resampling (SURVEY §2.2). Built here on
the GFI: each step *edits* the particle traces with an ``Update`` that
appends the next observation's constraint, so the incremental weight is the
SMCP3 edit weight — no model-specific code.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
from jax import lax
from jax.scipy.special import logsumexp

from genjax_xla.gfi.choice_map import ChoiceMap
from genjax_xla.gfi.gfn import GenerativeFunction, Trace
from genjax_xla.inference.smc import (
    effective_sample_size,
    resample_tree,
)

__all__ = [
    "ParticleFilter",
    "particle_filter",
    "bootstrap_filter",
]


class FilterState(NamedTuple):
    particles: Any  # per-particle latent state pytree (leading axis = K)
    log_weights: jax.Array
    log_z: jax.Array


def particle_filter(
    init: Callable[[jax.Array], tuple[Any, jax.Array]],
    step: Callable[[jax.Array, Any, Any], tuple[Any, jax.Array]],
    n_particles: int,
    ess_threshold: float = 0.5,
    resampling: str = "systematic",
    batched: bool = False,
    shard_constraint: Callable[[Any], Any] | None = None,
    stats_fn: Callable[[jax.Array], tuple[jax.Array, jax.Array]] | None = None,
    resample_fn: Callable[[jax.Array, jax.Array, Any], Any] | None = None,
):
    """Generic particle filter.

    - ``init(key) -> (state, log_w)``: sample an initial particle and its
      weight (given the first observation, if any).
    - ``step(key, state, obs_t) -> (state, log_incr_w)``: propagate one
      particle through one time step and weight it against ``obs_t``.

    With ``batched=True``, ``init``/``step`` receive ONE key and operate on
    whole ``(n_particles, ...)`` ensembles directly (array-level models):
    this skips the per-particle ``fold_in`` key derivation — the fastest
    path — at the cost of per-particle RNG determinism under resharding.

    Returns ``run(key, observations) -> (FilterState, log_z_per_step)``
    executing the whole filter in one ``lax.scan``; incremental weights,
    ESS, and resampling decisions are ensemble-wide reductions (mesh
    collectives when the particle axis is sharded).

    ``shard_constraint`` (optional): applied to the ensemble pytree after
    init and after each propagation — pass a
    ``with_sharding_constraint``-style function to pin the particle axis
    to a mesh axis (see ``genjax_xla.parallel.sharded_particle_filter``).

    ``stats_fn(log_weights) -> (lse, ess)`` and
    ``resample_fn(key, log_weights, particles) -> particles`` (optional):
    override the weight reductions and the resampling with explicit-
    collective implementations when the particle axis is sharded (the
    product distributed path — ``parallel.sharded_particle_filter``
    builds them from ``parallel.collectives``). Defaults reproduce the
    single-device computation exactly.
    """
    constrain = shard_constraint if shard_constraint is not None else (
        lambda tree: tree
    )
    if stats_fn is None:
        def stats_fn(lw):
            lse = logsumexp(lw)
            return lse, jnp.exp(2.0 * lse - logsumexp(2.0 * lw))

        def lse_fn(lw):
            return logsumexp(lw)
    else:
        # Emission points need lse only; reuse the caller's reduction
        # (the ESS half is dead code XLA removes when unused).
        def lse_fn(lw):
            return stats_fn(lw)[0]
    if resample_fn is None:
        def resample_fn(key, lw, particles):
            return resample_tree(key, lw, particles, n_particles, resampling)

    def run(key: jax.Array, observations: Any):
        k_init, k_scan = jax.random.split(key)
        if batched:
            states, log_ws = init(k_init)
        else:
            init_keys = jax.vmap(
                lambda i: jax.random.fold_in(k_init, i)
            )(jnp.arange(n_particles))
            states, log_ws = jax.vmap(init)(init_keys)
        states = constrain(states)
        log_ws = constrain(log_ws)
        state0 = FilterState(states, log_ws, jnp.zeros(()))

        def one_step(fs: FilterState, inp):
            t, obs_t = inp
            k_t = jax.random.fold_in(k_scan, t)
            k_res, k_prop = jax.random.split(k_t)

            # Adaptive resampling before propagation, behind a real
            # lax.cond: steps that keep the ensemble skip the ancestor
            # inversion + particle gather entirely (the expensive part of
            # a filter step at large K).
            # One ensemble-wide pass serves the ESS normalizer AND the
            # resample branch's logZ delta (a logsumexp inside the cond
            # could not be CSE'd with one outside it).
            lse, ess = stats_fn(fs.log_weights)

            def do_resample(fs: FilterState) -> FilterState:
                particles = constrain(resample_fn(
                    k_res, fs.log_weights, fs.particles,
                ))
                # Invariant: logẐ_t = log_z + logsumexp(w) − log K;
                # resampling absorbs the mass into log_z and resets w.
                logz_delta = lse - jnp.log(n_particles)
                return FilterState(
                    particles,
                    jnp.zeros_like(fs.log_weights),
                    fs.log_z + logz_delta,
                )

            fs = lax.cond(
                ess < ess_threshold * n_particles,
                do_resample,
                lambda fs: fs,
                fs,
            )

            # Propagate + weight.
            if batched:
                particles, incr = step(k_prop, fs.particles, obs_t)
            else:
                prop_keys = jax.vmap(
                    lambda i: jax.random.fold_in(k_prop, i)
                )(jnp.arange(n_particles))
                particles, incr = jax.vmap(
                    lambda k, s: step(k, s, obs_t)
                )(prop_keys, fs.particles)
            log_weights = constrain(fs.log_weights + incr)
            new_fs = FilterState(constrain(particles), log_weights, fs.log_z)
            return new_fs, fs.log_z + lse_fn(log_weights) - jnp.log(
                n_particles
            )

        n_steps = jtu.tree_leaves(observations)[0].shape[0]
        final, log_zs = lax.scan(
            one_step, state0, (jnp.arange(n_steps), observations)
        )
        final = FilterState(
            final.particles,
            final.log_weights,
            final.log_z + lse_fn(final.log_weights) - jnp.log(n_particles),
        )
        return final, log_zs

    return run


def bootstrap_filter(
    transition: GenerativeFunction,
    observation_logpdf: Callable[[Any, Any], jax.Array],
    n_particles: int,
    init_prior: GenerativeFunction | None = None,
    init_args: tuple = (),
    ess_threshold: float = 0.5,
    resampling: str = "systematic",
):
    """Bootstrap particle filter from generative functions:

    - ``init_prior`` (gen fn, args=init_args) samples the initial latent;
    - ``transition`` (gen fn, args=(state,)) samples the next latent;
    - ``observation_logpdf(state, obs_t)`` scores an observation.
    """

    if init_prior is None:
        raise ValueError("bootstrap_filter requires init_prior")

    def init(key):
        tr = init_prior.simulate(key, init_args)
        return tr.get_retval(), jnp.zeros(())

    def step(key, state, obs_t):
        tr = transition.simulate(key, (state,))
        new_state = tr.get_retval()
        return new_state, observation_logpdf(new_state, obs_t)

    return particle_filter(
        init, step, n_particles, ess_threshold, resampling
    )


class ParticleFilter:
    """OO façade over :func:`particle_filter` for repeated runs."""

    def __init__(self, init, step, n_particles, **kwargs):
        self._run = particle_filter(init, step, n_particles, **kwargs)
        self.n_particles = n_particles

    def run(self, key, observations):
        return self._run(key, observations)

    def __call__(self, key, observations):
        return self._run(key, observations)
