"""Sequential Monte Carlo: weighted particle collections, importance
sampling (SIR), conditional SMC, and target-change reweighting — plus
first-class resampling (systematic / stratified / multinomial), effective
sample size, and a rejuvenated SMC chain, which the reference lacks
(SURVEY §2.2: "no systematic resampler exists") but which particle
filtering at millions of particles requires.

Parity targets: ``/root/reference/src/genjax/_src/inference/smc.py``
(``ParticleCollection`` :76-109, ``SMCAlgorithm`` GenSP/VI methods :117-225,
``Importance`` :233-279, ``ImportanceK`` :282-351, ``ChangeTarget``
:359-465).

The particle axis is the distribution axis: every method here is pure and
vectorized along axis 0 of the collection, so the whole algorithm shards
across a device mesh by placing the particle axis on a mesh axis (see
``genjax_xla.parallel``).
"""

from __future__ import annotations

import abc
from typing import Any

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
from jax.scipy.special import logsumexp

from genjax_xla.core.pytree import Pytree
from genjax_xla.gfi.choice_map import ChoiceMap
from genjax_xla.gfi.concepts import Score, Weight
from genjax_xla.gfi.gfn import Trace
from genjax_xla.inference.sp import Algorithm, SampleDistribution, Target

__all__ = [
    "ParticleCollection",
    "resample_tree",
    "systematic_offspring_counts",
    "SMCAlgorithm",
    "Importance",
    "ImportanceK",
    "ChangeTarget",
    "effective_sample_size",
    "resample_indices",
    "resample_indices_sorted",
]


def _stack_end(xs, x):
    """Append ``x`` as the last lane of batched ``xs`` (leafwise)."""
    return jtu.tree_map(
        lambda a, b: jnp.concatenate(
            [jnp.asarray(a), jnp.asarray(b)[None]], axis=0
        ),
        xs, x,
    )


# ---------------------------------------------------------------------------
# Resampling primitives (new scope vs. the reference)
# ---------------------------------------------------------------------------


def effective_sample_size(log_weights: jax.Array) -> jax.Array:
    """ESS = (Σw)² / Σw² of the normalized weights, in [1, K]."""
    lw = log_weights - logsumexp(log_weights)
    return jnp.exp(-logsumexp(2.0 * lw))


def _ancestors_from_counts(counts_cum: jax.Array, n: int) -> jax.Array:
    """Invert cumulative offspring counts into sorted ancestor indices via
    scatter-add + cumsum (O(n), with no per-query binary search)."""
    k = counts_cum.shape[0]
    starts = jnp.concatenate(
        [jnp.zeros(1, counts_cum.dtype), counts_cum[:-1]]
    )
    # Particles with zero offspring whose start lands at n scatter out of
    # bounds and are dropped (mode="drop") — do NOT clip them into range.
    marks = jnp.zeros(n, jnp.int32).at[starts].add(1, mode="drop")
    return jnp.clip(jnp.cumsum(marks) - 1, 0, k - 1)


def _sorted_searchsorted(cum: jax.Array, us: jax.Array) -> jax.Array:
    """``searchsorted(cum, us)`` for *sorted* ``us`` — two ``lax.sort``
    passes with payload operands, no scatter and no per-query binary
    search, so it composes under ``vmap`` into one batched sort."""
    k, n = cum.shape[0], us.shape[0]
    comb = jnp.concatenate([cum, us])
    is_query = jnp.concatenate(
        [jnp.zeros(k, jnp.int32), jnp.ones(n, jnp.int32)]
    )
    # Merge-sort; ties put cum entries first, so a query equal to a cum
    # boundary counts it — #{cum <= u}, i.e. searchsorted side='right'.
    # That is the DESIRED owner convention: a zero-weight particle's
    # cum equals its predecessor's, and side='right' skips it when a
    # grid point lands exactly on the shared boundary.
    _, flags = jax.lax.sort((comb, is_query), num_keys=1, is_stable=True)
    cum_before = jnp.cumsum(1 - flags)           # #cum entries ≤ position
    query_rank = jnp.cumsum(flags) - 1           # rank among queries
    # Route each query's answer back to its rank: sort by (non-query?,
    # rank) carrying cum_before; the first n slots are the results in
    # query order.
    route_key = jnp.where(flags == 1, query_rank, n + 1)
    _, routed = jax.lax.sort(
        (route_key, cum_before), num_keys=1, is_stable=True
    )
    return jnp.clip(routed[:n].astype(jnp.int32), 0, k - 1)


def systematic_offspring_cumulative(key: jax.Array,
                                    log_weights: jax.Array,
                                    n: int) -> jax.Array:
    """Inclusive cumulative offspring counts of systematic resampling,
    in closed form from the weight CDF (no ancestor indices
    materialized). ``counts_cum[i] = #dests assigned to particles 0..i``;
    per-particle counts are its first difference, and
    :func:`_ancestors_from_counts` inverts it into ancestor indices.

    The final entry is pinned to exactly ``n``: mathematically
    ``ceil(n·1 − u0) = n`` for ``u0 ∈ (0, 1)``, but f32 cumsum rounding
    at large K otherwise loses dests (measured at 2^20: the raw
    cumulative lands at ``n−1`` for ~25% of seeds, silently leaving the
    last dest unfilled)."""
    cum = jnp.cumsum(jnp.exp(log_weights - jnp.max(log_weights)))
    # XLA's pairwise cumsum is not monotone at the ulp level (different
    # association per prefix), and a 1-ulp dip here becomes a -1/+1
    # count pair — a dest assigned to TWO sources. cummax restores the
    # nondecreasing invariant exactly (monotone cum → monotone
    # ceil/clip downstream).
    cum = jax.lax.cummax(cum)
    u0 = jax.random.uniform(key, ())
    scale = n / cum[-1]
    counts_cum = jnp.clip(
        jnp.ceil(cum * scale - u0), 0, n
    ).astype(jnp.int32)
    return counts_cum.at[-1].set(n)


def systematic_offspring_counts(key: jax.Array, log_weights: jax.Array,
                                n: int) -> jax.Array:
    """Per-particle offspring counts of systematic resampling (first
    difference of :func:`systematic_offspring_cumulative`)."""
    counts_cum = systematic_offspring_cumulative(key, log_weights, n)
    return jnp.diff(
        jnp.concatenate([jnp.zeros(1, jnp.int32), counts_cum])
    )


def resample_tree(key: jax.Array, log_weights: jax.Array, tree,
                  n: int, method: str = "systematic", invariant=None):
    """Resample every leaf of ``tree`` (leading axis = particles).

    One ancestor-index vector (:func:`resample_indices`) and one row
    gather per leaf. For systematic resampling this is bitwise
    ``jnp.repeat(v, counts, total_repeat_length=n)`` of the same
    offspring counts, and it was the fastest of three formulations of
    that expansion measured end to end in the 2^20-particle tracking
    filter, on an H100 and on the CPU alike (``PERF.md``).

    ``invariant`` (optional): a pytree of bools matching ``tree``'s
    leaves; True marks a leaf as identical across particles (e.g. the
    constrained observation values every trace carries) — such leaves
    are returned untouched, skipping their (often wide) data movement.
    Compute it with ``core.compiler.taint.variant_leaf_mask`` (negated);
    passing an invariant mask never changes the result, only the cost
    (a True-marked leaf that actually varied across particles WOULD
    change results — the taint analysis is conservative so this cannot
    happen for masks it produced)."""
    if invariant is not None:
        leaves, treedef = jtu.tree_flatten(tree)
        inv_flat = jtu.tree_leaves(invariant)
        assert len(inv_flat) == len(leaves), (
            "invariant mask / tree leaf mismatch"
        )
        var_leaves = tuple(
            l for l, iv in zip(leaves, inv_flat) if not iv
        )
        if var_leaves:
            var_res = resample_tree(
                key, log_weights, var_leaves, n, method
            )
        else:
            var_res = ()
        it = iter(var_res)
        # Invariant leaves: any n rows are the same rows (all particles
        # carry identical values), so a plain slice replaces the
        # expansion — identity when the ensemble size is unchanged,
        # a cheap contiguous slice when resampling n_src -> n (e.g.
        # waste-free SMC's N -> M starter draw). Upsampling n > n_src
        # would silently produce a RAGGED ensemble; guard it.
        for l, iv in zip(leaves, inv_flat):
            if iv and l.shape[0] < n:
                raise ValueError(
                    "resample_tree: invariant leaf has "
                    f"{l.shape[0]} rows < n={n}; invariant-leaf "
                    "slicing only supports n <= source count"
                )
        merged = [
            (l[:n] if iv else next(it))
            for l, iv in zip(leaves, inv_flat)
        ]
        return jtu.tree_unflatten(treedef, merged)
    idx = resample_indices(key, log_weights, n, method)
    return jtu.tree_map(lambda v: v[idx], tree)


def resample_indices(key: jax.Array, log_weights: jax.Array, n: int,
                     method: str = "systematic") -> jax.Array:
    """Draw ``n`` sorted ancestor indices proportional to
    ``exp(log_weights)``.

    All three methods are O(K log K) or better with no per-query binary
    search: ``systematic`` (default) counts grid hits per particle in
    closed form; ``stratified`` and ``multinomial`` use sorted uniforms +
    a single merge-rank sort."""
    k = log_weights.shape[0]
    if method == "systematic":
        # #{i : (u0 + i)/n < cum_k} = ceil(n·cum_k − u0), exact tail
        # (see systematic_offspring_cumulative).
        counts_cum = systematic_offspring_cumulative(key, log_weights, n)
        return _ancestors_from_counts(counts_cum, n)
    norm = jax.nn.softmax(log_weights)
    cum = jnp.cumsum(norm)
    if method == "stratified":
        us = (jax.random.uniform(key, (n,)) + jnp.arange(n)) / n
        return _sorted_searchsorted(cum, us)
    elif method == "multinomial":
        es = jax.random.exponential(key, (n + 1,))
        # Sorted uniforms via normalized exponential spacings.
        us = jnp.cumsum(es)[:-1] / jnp.sum(es)
        return _sorted_searchsorted(cum, us)
    raise ValueError(f"Unknown resampling method: {method!r}")


def resample_indices_sorted(key: jax.Array, log_weights: jax.Array,
                            n: int,
                            method: str = "systematic") -> jax.Array:
    """Single-row sort-based ancestor draw: the same batched-merge
    inversion as :func:`resample_indices_rows` without the row axis —
    the vmap-friendly primitive for per-lane inner filters (SMC²/PMMH
    re-runs vmap this over θ). Unlike :func:`resample_indices`'s systematic
    branch (counts + scatter-marks — fastest unbatched), every step
    here is sort/compare only, so it composes under vmap with no
    batched-scatter lowering."""
    k = log_weights.shape[0]
    cum = jnp.cumsum(jax.nn.softmax(log_weights))
    if method == "systematic":
        us = (jax.random.uniform(key, ()) + jnp.arange(n)) / n
    elif method == "stratified":
        us = (jax.random.uniform(key, (n,)) + jnp.arange(n)) / n
    elif method == "multinomial":
        es = jax.random.exponential(key, (n + 1,))
        us = jnp.cumsum(es)[:-1] / jnp.sum(es)
    else:
        raise ValueError(f"Unknown resampling method: {method!r}")
    return _sorted_searchsorted(cum, us)


def resample_indices_rows(key: jax.Array, log_weights: jax.Array,
                          n: int, method: str = "multinomial") -> jax.Array:
    """Row-batched :func:`resample_indices`: ``(R, K)`` log-weights →
    ``(R, n)`` sorted ancestors from ONE key. All randomness is drawn
    in single batched calls (one exponential/uniform field, one batched
    merge sort) instead of R per-row ``fold_in``+``split`` chains.
    (End-to-end neutral inside SMC² — XLA overlaps the per-row key
    math — but the single-key dataflow is simpler and this is the
    natural primitive for row-ensemble methods.)

    ``"systematic"``: one uniform per ROW offsets the shared grid
    ``(j + u0_r)/n`` — stratified's grid with a common offset —
    inverted against the row CDF by the same batched merge sort, so it
    costs the same as stratified. Lower offspring variance than
    multinomial at identical throughput class — the SMC² inner-filter
    default."""
    r, _k = log_weights.shape
    norm = jax.nn.softmax(log_weights, axis=1)
    cum = jnp.cumsum(norm, axis=1)
    if method == "systematic":
        us = (
            jax.random.uniform(key, (r, 1))
            + jnp.arange(n)[None, :]
        ) / n
    elif method == "stratified":
        us = (
            jax.random.uniform(key, (r, n))
            + jnp.arange(n)[None, :]
        ) / n
    elif method == "multinomial":
        es = jax.random.exponential(key, (r, n + 1))
        us = (
            jnp.cumsum(es[:, :-1], axis=1)
            / jnp.sum(es, axis=1, keepdims=True)
        )
    else:
        raise ValueError(f"Unknown resampling method: {method!r}")
    return jax.vmap(_sorted_searchsorted)(cum, us)


# ---------------------------------------------------------------------------
# Particle collections
# ---------------------------------------------------------------------------


@Pytree.dataclass
class ParticleCollection(Pytree):
    """Weighted particles: vectorized traces (axis 0 = particle axis), log
    importance weights, and a validity flag.

    Parity: reference ``smc.py:76-109`` + new ESS / resample methods."""

    particles: Trace
    log_weights: jax.Array
    is_valid: jax.Array

    def get_particles(self) -> Trace:
        return self.particles

    def get_particle(self, idx) -> Trace:
        return jtu.tree_map(lambda v: v[idx], self.particles)

    def get_log_weights(self) -> jax.Array:
        return self.log_weights

    def num_particles(self) -> int:
        return self.log_weights.shape[0]

    def get_log_marginal_likelihood_estimate(self) -> jax.Array:
        return logsumexp(self.log_weights) - jnp.log(self.num_particles())

    def effective_sample_size(self) -> jax.Array:
        return effective_sample_size(self.log_weights)

    def __getitem__(self, idx):
        return jtu.tree_map(
            lambda v: v[idx], (self.particles, self.log_weights)
        )

    def sample_particle(self, key: jax.Array) -> Trace:
        """One particle drawn with probability ∝ weight."""
        idx = jax.random.categorical(key, self.log_weights)
        return self.get_particle(idx)

    def resample(self, key: jax.Array,
                 method: str = "systematic") -> "ParticleCollection":
        """Equal-weight collection drawn by ancestor resampling; the log-Z
        contribution moves into the (uniform) weights so that
        ``get_log_marginal_likelihood_estimate`` telescopes across steps."""
        n = self.num_particles()
        new_particles = resample_tree(
            key, self.log_weights, self.particles, n, method
        )
        logz = self.get_log_marginal_likelihood_estimate()
        return ParticleCollection(
            new_particles,
            jnp.full((n,), logz),
            self.is_valid,
        )


# ---------------------------------------------------------------------------
# SMC algorithms
# ---------------------------------------------------------------------------


class SMCAlgorithm(Algorithm):
    """Abstract SMC algorithm: defined by ``run_smc`` and ``run_csmc``;
    GenSP and VI methods derive by composing with :class:`ChangeTarget`.

    Parity: reference ``smc.py:117-225``."""

    @abc.abstractmethod
    def get_num_particles(self) -> int: ...

    @abc.abstractmethod
    def get_final_target(self) -> Target: ...

    @abc.abstractmethod
    def run_smc(self, key: jax.Array) -> ParticleCollection: ...

    @abc.abstractmethod
    def run_csmc(self, key: jax.Array,
                 retained: ChoiceMap) -> ParticleCollection: ...

    # -- convenience -------------------------------------------------------

    def log_marginal_likelihood_estimate(
        self, key: jax.Array, target: Target | None = None
    ) -> jax.Array:
        alg: SMCAlgorithm = ChangeTarget(self, target) if target else self
        _, sub_key = jax.random.split(key)
        return alg.run_smc(sub_key).get_log_marginal_likelihood_estimate()

    # -- GenSP -------------------------------------------------------------

    def random_weighted(self, key: jax.Array, *args):
        target: Target = args[0]
        alg = ChangeTarget(self, target)
        key, sub_key = jax.random.split(key)
        collection = alg.run_smc(key)
        particle = collection.sample_particle(sub_key)
        log_density_estimate = (
            particle.get_score()
            - collection.get_log_marginal_likelihood_estimate()
        )
        chm = target.filter_to_unconstrained(particle.get_choices())
        return log_density_estimate, chm

    def estimate_logpdf(self, key: jax.Array, v: ChoiceMap, *args) -> Score:
        """Density estimate at ``v``: log p̃(v) − log Ẑ_csmc(v), using the
        *retained* particle's score (exactly unbiased for the algorithm's
        output density by the ADH identity; the reference samples a random
        particle here, ``smc.py:181-197``, which estimates the density at
        the wrong point)."""
        target: Target = args[0]
        alg = ChangeTarget(self, target)
        collection = alg.run_csmc(key, v)
        return (
            collection.get_particle(-1).get_score()
            - collection.get_log_marginal_likelihood_estimate()
        )

    # -- VI hooks ----------------------------------------------------------

    def estimate_normalizing_constant(self, key: jax.Array,
                                      target: Target) -> Weight:
        alg = ChangeTarget(self, target)
        _, sub_key = jax.random.split(key)
        return alg.run_smc(sub_key).get_log_marginal_likelihood_estimate()

    def estimate_reciprocal_normalizing_constant(
        self, key: jax.Array, target: Target, latent_choices: ChoiceMap,
        w: Weight,
    ) -> Weight:
        """−logẐ from the retained-pair CSMC ensemble (``exp`` of the
        result is the ADH unbiased reciprocal estimate given the pair)."""
        alg = ChangeTarget(self, target)
        return -alg.run_csmc_for_normalizing_constant(
            key, latent_choices, w
        )

    def estimate_marginal_density(
        self, key: jax.Array, target: Target, latent_choices: ChoiceMap,
        w: Weight,
    ) -> Weight:
        """+logẐ — the log marginal density estimate of the target's
        constraint, reusing the properly-weighted retained pair."""
        alg = ChangeTarget(self, target)
        return alg.run_csmc_for_normalizing_constant(key, latent_choices, w)


@Pytree.dataclass
class Importance(SMCAlgorithm):
    """1-particle importance sampling from ``target`` with optional proposal
    ``q`` (a :class:`SampleDistribution` over a subset of the unconstrained
    addresses). Parity: reference ``smc.py:233-279``."""

    target: Target | None = None
    q: SampleDistribution | None = None

    def get_num_particles(self) -> int:
        return 1

    def get_final_target(self) -> Target:
        assert self.target is not None
        return self.target

    def run_smc(self, key: jax.Array) -> ParticleCollection:
        target = self.get_final_target()
        key, sub_key = jax.random.split(key)
        if self.q is not None:
            q_w, choice = self.q.random_weighted(sub_key, target)
        else:
            q_w, choice = 0.0, ChoiceMap.empty()
        tr, target_w = target.importance(key, choice)
        return ParticleCollection(
            jtu.tree_map(lambda v: jnp.asarray(v)[None], tr),
            jnp.atleast_1d(target_w - q_w),
            jnp.asarray(True),
        )

    def run_csmc(self, key: jax.Array, retained: ChoiceMap):
        target = self.get_final_target()
        key, sub_key = jax.random.split(key)
        tr, target_w = target.importance(key, retained)
        if self.q is not None:
            q_w = self.q.estimate_logpdf(sub_key, retained, target)
        else:
            # Internal (ancestral-prior) proposal: the retained particle's
            # weight must be computed exactly as a free particle's would be,
            # w = log p̃(v) − log r(v) with r the ancestral prior of the
            # retained addresses — otherwise the CSMC normalizing estimate
            # over-weights the retained lane and `estimate_logpdf` is biased
            # (ADH identity: q̂_SIR(v) = p̃(v)·E[1/Ẑ_csmc]). The reference
            # (`smc.py:267-278`) uses the full joint here; we deviate
            # deliberately — see tests/inference/test_smc.py for the
            # enumerated unbiasedness check.
            q_w = tr.project(sub_key, retained.get_selection())
        return ParticleCollection(
            jtu.tree_map(lambda v: jnp.asarray(v)[None], tr),
            jnp.atleast_1d(target_w - q_w),
            jnp.asarray(True),
        )


@Pytree.dataclass
class ImportanceK(SMCAlgorithm):
    """K-particle sampling-importance-resampling. The particle axis is a
    ``vmap`` axis — shardable over a device mesh.

    Parity: reference ``smc.py:282-351``."""

    target: Target | None = None
    q: SampleDistribution | None = None
    k_particles: int = Pytree.static(default=2)

    def get_num_particles(self) -> int:
        return self.k_particles

    def get_final_target(self) -> Target:
        assert self.target is not None
        return self.target

    def run_smc(self, key: jax.Array) -> ParticleCollection:
        target = self.get_final_target()
        key, sub_key = jax.random.split(key)
        sub_keys = jax.random.split(sub_key, self.k_particles)
        if self.q is not None:
            q_ws, choices = jax.vmap(
                self.q.random_weighted, in_axes=(0, None)
            )(sub_keys, target)
            # Fresh keys for the model's fill-in of unconstrained
            # addresses (reusing sub_keys would correlate it with the
            # proposal draws).
            imp_keys = jax.random.split(key, self.k_particles)
            trs, target_ws = jax.vmap(target.importance)(imp_keys, choices)
        else:
            q_ws = 0.0
            trs, target_ws = jax.vmap(target.importance, in_axes=(0, None))(
                sub_keys, ChoiceMap.empty()
            )
        return ParticleCollection(trs, target_ws - q_ws, jnp.asarray(True))

    def run_csmc(self, key: jax.Array, retained: ChoiceMap):
        target = self.get_final_target()
        key, sub_key = jax.random.split(key)
        sub_keys = jax.random.split(sub_key, self.k_particles - 1)
        if self.q is not None:
            key, ret_key, imp_key = jax.random.split(key, 3)
            q_ws, choices = jax.vmap(
                self.q.random_weighted, in_axes=(0, None)
            )(sub_keys, target)
            retained_q_w = self.q.estimate_logpdf(ret_key, retained, target)
            all_choices = _stack_end(choices, retained)
            all_q_ws = _stack_end(q_ws, retained_q_w)
            all_keys = jax.random.split(imp_key, self.k_particles)
            trs, target_ws = jax.vmap(target.importance)(
                all_keys, all_choices
            )
            return ParticleCollection(
                trs, target_ws - all_q_ws, jnp.asarray(True)
            )
        free_trs, free_ws = jax.vmap(target.importance, in_axes=(0, None))(
            sub_keys, ChoiceMap.empty()
        )
        key, proj_key = jax.random.split(key)
        ret_tr, ret_w = target.importance(key, retained)
        # Same retained-weight correction as `Importance.run_csmc`.
        ret_w = ret_w - ret_tr.project(proj_key, retained.get_selection())
        trs = _stack_end(free_trs, ret_tr)
        ws = _stack_end(free_ws, ret_w)
        return ParticleCollection(trs, ws, jnp.asarray(True))


@Pytree.dataclass
class ChangeTarget(SMCAlgorithm):
    """Reweight every particle of ``prev`` to a new target: fresh importance
    of each particle's latents into ``target``; weight picks up the density
    ratio. Parity: reference ``smc.py:359-465``."""

    prev: SMCAlgorithm
    target: Target

    def get_num_particles(self) -> int:
        return self.prev.get_num_particles()

    def get_final_target(self) -> Target:
        return self.target

    def _reweight_particle(self, key, particle, weight):
        """One particle's fresh importance into the new target; the weight
        picks up the density ratio (shared by run_smc/run_csmc and the
        normalizing-constant path)."""
        latents = self.prev.get_final_target().filter_to_unconstrained(
            particle.get_choices()
        )
        new_tr, new_w = self.target.importance(key, latents)
        return new_tr, new_w - particle.get_score() + weight

    def _reweight_collection(self, key, collection) -> ParticleCollection:
        sub_keys = jax.random.split(key, self.get_num_particles())
        new_particles, new_weights = jax.vmap(self._reweight_particle)(
            sub_keys, collection.get_particles(), collection.get_log_weights()
        )
        return ParticleCollection(
            new_particles, new_weights, jnp.asarray(True)
        )

    def run_smc(self, key: jax.Array) -> ParticleCollection:
        key, rw_key = jax.random.split(key)
        collection = self.prev.run_smc(key)
        return self._reweight_collection(rw_key, collection)

    def run_csmc(self, key: jax.Array, retained: ChoiceMap):
        key, rw_key = jax.random.split(key)
        collection = self.prev.run_csmc(key, retained)
        return self._reweight_collection(rw_key, collection)

    def run_csmc_for_normalizing_constant(
        self, key: jax.Array, latent_choices: ChoiceMap, w: Weight
    ) -> Weight:
        """Normalizing-constant (logẐ) estimate from a CSMC ensemble that
        retains the already properly-weighted pair ``(latent_choices, w)``
        — avoiding a redundant reweighting that would add gradient
        variance. Conditioned on the retained pair, ``exp(−logẐ)`` is the
        ADH unbiased reciprocal estimate.

        Deviation from the reference (``smc.py:432-465``): the reference
        returns ``retained_score − (logẐ_sum − log K)``, which degenerates
        to 0 when nothing is marginalized — making ``Marginal``-as-guide
        weights vanish (and silently dropping the entropy term from
        ELBO-style objectives). The correct quantity is the logẐ estimate
        itself; see tests/inference/test_smc.py and the Marginal-as-
        proposal test in tests/lang/test_composition_stress.py."""
        key, sub_key = jax.random.split(key)
        collection = self.prev.run_csmc(sub_key, latent_choices)
        n = self.get_num_particles()

        def reweight(key, particle, weight):
            _, w_out = self._reweight_particle(key, particle, weight)
            return w_out

        sub_keys = jax.random.split(key, n - 1)
        rejected = jax.vmap(reweight)(
            sub_keys,
            jtu.tree_map(lambda v: v[:-1], collection.get_particles()),
            collection.get_log_weights()[:-1],
        )
        retained_score = collection.get_particle(-1).get_score()
        retained_weight = collection.get_log_weights()[-1]
        all_weights = jnp.concatenate(
            [rejected, (w - retained_score + retained_weight)[None]]
        )
        return logsumexp(all_weights) - jnp.log(n)
