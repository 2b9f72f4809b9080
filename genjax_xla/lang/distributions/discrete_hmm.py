"""Exact discrete HMM posterior as a distribution: forward-filter
backward-sample (FFBS), exact data marginals, and a parallel-prefix
(``lax.associative_scan``) forward filter for long sequences.

Parity target: ``/root/reference/src/genjax/_src/generative_functions/
distributions/custom/discrete_hmm.py`` (``DiscreteHMMConfiguration`` :54
with circulant transition/observation tensors :42-86, FFBS via two scans
:98-192, exact posterior/data marginal :200-239, ``DiscreteHMM`` :267).

Extension: ``forward_filter_parallel`` computes all filtering
distributions with O(log T) depth via associative log-matmul prefix scan —
the work becomes batched matrix products, and long state-space sequences stop being
latency-bound (SURVEY §2.3 sequence-parallel strategy).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
from jax.scipy.special import logsumexp

from genjax_xla.core.pytree import Pytree
from genjax_xla.gfi.choice_map import ChoiceMap
from genjax_xla.lang.distributions.distribution import Distribution, DistributionTrace

__all__ = [
    "DiscreteHMMConfiguration",
    "DiscreteHMM",
    "discrete_hmm",
    "forward_filter",
    "forward_filter_parallel",
    "backward_sample",
    "backward_sample_parallel",
    "log_data_marginal",
]


@Pytree.dataclass
class DiscreteHMMConfiguration(Pytree):
    """HMM parameters in log space: ``prior_logits`` (S,), row-normalized
    ``transition_logits`` (S, S) with ``[i, j] = log P(z'=j | z=i)``, and
    ``observation_logits`` (S, O) with ``[i, k] = log P(x=k | z=i)``."""

    prior_logits: jax.Array
    transition_logits: jax.Array
    observation_logits: jax.Array

    @staticmethod
    def from_probs(prior, transition, observation):
        return DiscreteHMMConfiguration(
            jnp.log(prior), jnp.log(transition), jnp.log(observation)
        )

    @staticmethod
    def circulant(
        num_states: int,
        num_obs: int,
        transition_distance: float = 1.0,
        observation_distance: float = 1.0,
        transition_variance: float = 1.0,
        observation_variance: float = 1.0,
    ) -> "DiscreteHMMConfiguration":
        """Circulant transition/observation structure à la the reference
        testbed (``discrete_hmm.py:42-86``): probability decays with
        (wrap-around) distance from the current state."""

        def circ_logits(n_row, n_col, distance, variance):
            i = jnp.arange(n_row)[:, None]
            j = jnp.arange(n_col)[None, :]
            d = jnp.minimum(jnp.abs(i - j), n_row - jnp.abs(i - j))
            logits = -jnp.square(d.astype(jnp.result_type(float)) * distance) / (
                2.0 * variance
            )
            return jax.nn.log_softmax(logits, axis=-1)

        prior = jax.nn.log_softmax(jnp.zeros(num_states))
        trans = circ_logits(num_states, num_states, transition_distance,
                            transition_variance)
        obs = circ_logits(num_states, num_obs, observation_distance,
                          observation_variance)
        return DiscreteHMMConfiguration(prior, trans, obs)

    @property
    def num_states(self) -> int:
        return self.prior_logits.shape[-1]


# Log-space matrix product as a max-shifted matmul at full float32
# precision: see genjax_xla/ops/logmatmul.py.
from genjax_xla.ops.logmatmul import log_matmul  # noqa: E402


def forward_filter(config: DiscreteHMMConfiguration,
                   observations: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Sequential forward filtering. Returns ``(alphas, log_marginal)``
    where ``alphas[t, s] = log P(z_t = s, x_{1:t})``."""
    obs_ll = config.observation_logits[:, observations].T  # (T, S)
    alpha0 = config.prior_logits + obs_ll[0]

    def step(alpha, obs_t):
        next_alpha = (
            logsumexp(alpha[:, None] + config.transition_logits, axis=0)
            + obs_t
        )
        return next_alpha, next_alpha

    _, rest = lax.scan(step, alpha0, obs_ll[1:])
    alphas = jnp.concatenate([alpha0[None], rest], axis=0)
    return alphas, logsumexp(alphas[-1])


def forward_filter_parallel(
    config: DiscreteHMMConfiguration, observations: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """Parallel-prefix forward filtering: O(log T) depth via an associative
    scan over log-space transition·observation matrices."""
    obs_ll = config.observation_logits[:, observations].T  # (T, S)
    # M_t[i, j] = log P(z_t = j, x_t | z_{t-1} = i) for t >= 1.
    Ms = config.transition_logits[None, :, :] + obs_ll[1:, None, :]
    prefix = lax.associative_scan(log_matmul, Ms)  # (T-1, S, S)
    alpha0 = config.prior_logits + obs_ll[0]
    rest = logsumexp(alpha0[None, :, None] + prefix, axis=1)  # (T-1, S)
    alphas = jnp.concatenate([alpha0[None], rest], axis=0)
    return alphas, logsumexp(alphas[-1])


def backward_sample_parallel(key: jax.Array,
                             config: DiscreteHMMConfiguration,
                             alphas: jax.Array) -> jax.Array:
    """O(log T)-depth exact posterior path sampling.

    Sequential FFBS samples z_t | z_{t+1} one step at a time. Here we
    instead materialize, for every step t, the *sampling function*
    ``f_t : z_{t+1} ↦ z_t`` (inverse-CDF with one uniform per step, applied
    to every conditioning state j — an (S,)-vector of ints), then collapse
    the chain of function compositions with ``lax.associative_scan`` whose
    combine is gather-composition ``(a ∘ b)[j] = a[b[j]]``. Total depth
    O(log T) — the sequence axis is fully parallel, like the forward
    filter."""
    T, S = alphas.shape
    k_last, k_steps = jax.random.split(key)
    z_T = jax.random.categorical(k_last, alphas[-1])

    # Per-step conditional logits: L_t[j, s] = log P(z_t = s | z_{t+1}=j).
    # (t ranges over 0..T-2; condition state j is z_{t+1}.)
    cond_logits = (
        alphas[:-1][:, None, :]                      # (T-1, 1, S)
        + config.transition_logits.T[None, :, :]     # (1, S, S): [j, s]
    )
    # One uniform per step, shared across conditioning states (valid: only
    # one conditioning state is ever realized per step).
    us = jax.vmap(
        lambda t: jax.random.uniform(jax.random.fold_in(k_steps, t))
    )(jnp.arange(T - 1))
    probs = jax.nn.softmax(cond_logits, axis=-1)
    cdf = jnp.cumsum(probs, axis=-1)                  # (T-1, S, S)
    # Inverse CDF: f_t[j] = first s with cdf >= u_t.
    tables = jnp.argmax(
        cdf >= us[:, None, None], axis=-1
    ).astype(jnp.int32)                               # (T-1, S)

    # Compose backward: M_t = f_t ∘ f_{t+1} ∘ ... ∘ f_{T-2}; then
    # z_t = M_t[z_T]. associative_scan on reversed tables with
    # combine(a, b)[j] = a[b[j]] (a applied after b's output feeds it).
    def compose(a, b):
        # batched gather-composition over the leading (scan) axis
        return jnp.take_along_axis(a, b, axis=-1)

    rev = tables[::-1]                                # f_{T-2}, ..., f_0
    acc = jax.lax.associative_scan(
        lambda b, a: compose(a, b), rev
    )
    # acc[k] = f_{T-2-k} ∘ ... ∘ f_{T-2}; so z_{T-2-k} = acc[k][z_T].
    zs_rev = acc[:, z_T] if acc.ndim == 2 else acc[..., z_T]
    zs = zs_rev[::-1]
    return jnp.concatenate([zs, z_T[None]], axis=0)


def backward_sample(key: jax.Array, config: DiscreteHMMConfiguration,
                    alphas: jax.Array) -> jax.Array:
    """Sample a latent path from the exact posterior given filtered
    ``alphas``; returns ``z`` with shape (T,)."""
    T = alphas.shape[0]
    z_T = jax.random.categorical(key, alphas[-1])

    def step(z_next, inp):
        t, sub_key = inp
        logits = alphas[t] + config.transition_logits[:, z_next]
        z_t = jax.random.categorical(sub_key, logits)
        return z_t, z_t

    ts = jnp.arange(T - 2, -1, -1)
    keys = jax.vmap(lambda t: jax.random.fold_in(key, t))(ts)
    _, zs_rev = lax.scan(step, z_T, (ts, keys))
    return jnp.concatenate([zs_rev[::-1], z_T[None]], axis=0)


def posterior_logpdf(config: DiscreteHMMConfiguration, z: jax.Array,
                     observations: jax.Array) -> jax.Array:
    """Exact ``log P(z | x)`` = joint − marginal."""
    joint = joint_logpdf(config, z, observations)
    _, logm = forward_filter(config, observations)
    return joint - logm


def joint_logpdf(config: DiscreteHMMConfiguration, z: jax.Array,
                 observations: jax.Array) -> jax.Array:
    prior = config.prior_logits[z[0]]
    trans = jnp.sum(config.transition_logits[z[:-1], z[1:]])
    obs = jnp.sum(config.observation_logits[z, observations])
    return prior + trans + obs


def log_data_marginal(config: DiscreteHMMConfiguration,
                      observations: jax.Array) -> jax.Array:
    """Exact ``log P(x_{1:T})``."""
    _, logm = forward_filter(config, observations)
    return logm


@Pytree.dataclass
class DiscreteHMM(Distribution):
    """The exact latent-sequence posterior of a discrete HMM as a
    Distribution over paths: args = (config, observations).

    Parity: reference ``discrete_hmm.py:242-267``."""

    use_parallel_filter: bool = Pytree.static(default=False)

    def _filter(self, config, observations):
        if self.use_parallel_filter:
            return forward_filter_parallel(config, observations)
        return forward_filter(config, observations)

    def random_weighted(self, key, config, observations):
        alphas, logm = self._filter(config, observations)
        if self.use_parallel_filter:
            z = backward_sample_parallel(key, config, alphas)
        else:
            z = backward_sample(key, config, alphas)
        score = joint_logpdf(config, z, observations) - logm
        return score, z

    def estimate_logpdf(self, key, z, config, observations):
        _, logm = self._filter(config, observations)
        return joint_logpdf(config, z, observations) - logm


#: Singleton (sequential filter).
discrete_hmm = DiscreteHMM()
