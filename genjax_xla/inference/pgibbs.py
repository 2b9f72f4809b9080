"""Particle Gibbs (conditional SMC) with optional ancestor sampling,
for state-space models at the array level.

New scope relative to the reference (its only conditional-SMC artifact
is the single-step ``run_csmc`` retained-particle importance lane,
``/root/reference/src/genjax/_src/inference/smc.py:317-351`` — no
sequential filter, no Gibbs iteration): Particle Gibbs (Andrieu,
Doucet & Holenstein 2010) targets the exact joint smoothing posterior
p(x_{1:T} | y_{1:T}) by iterating a conditional bootstrap filter —
one lane pinned to the current reference trajectory — and drawing the
next reference by ancestral tracing from the final weights. Ancestor
sampling (Lindsten, Jordan & Schön 2014, PGAS) additionally resamples
the retained lane's ancestor at every step using the transition
density, which breaks path degeneracy and makes the sampler mix at
small N even for long T.

Shape: particle lanes are a vmap axis; the per-iteration
filter is one ``lax.scan`` over time, the ancestral backward trace a
second reversed scan over stored ancestor indices (O(T) int gathers of
K-vectors — tiny); the whole Gibbs chain is a third scan. Free-lane
ancestors use MULTINOMIAL resampling (exact conditional validity; the
conditional version of low-variance schemes needs a coupling argument
the multinomial case avoids).

Model interface (mirrors ``pf.particle_filter``'s batched mode):
- ``init_sampler(key, n) -> (n, ...) states`` — prior draw of x_1;
- ``propagate(key, xs) -> xs_next`` — whole-ensemble transition;
- ``loglik(xs, y_t) -> (n,)`` — observation log density;
- ``trans_logpdf(x_prev, x_next) -> (n,)`` (optional) — transition
  density of one next-state against an ensemble of previous states;
  supplying it enables ancestor sampling.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
from jax import lax
from jax.scipy.special import logsumexp

from genjax_xla.inference.smc import resample_indices

__all__ = ["ParticleGibbsResult", "conditional_bootstrap_filter",
           "particle_gibbs", "TraceParticleGibbsResult",
           "trace_csmc", "trace_particle_gibbs"]


class ParticleGibbsResult(NamedTuple):
    paths: Any              # (n_iters, T, ...) reference trajectories
    log_zs: jax.Array       # (n_iters,) per-sweep CSMC logZ estimates
    final_path: Any         # (T, ...) last reference trajectory


def _set_lane(tree, idx, value_tree):
    return jtu.tree_map(
        lambda xs, v: xs.at[idx].set(v), tree, value_tree
    )


def _gather_lanes(tree, idx):
    return jtu.tree_map(lambda xs: xs[idx], tree)


def conditional_bootstrap_filter(
    init_sampler: Callable,
    propagate: Callable,
    loglik: Callable,
    n_particles: int,
    trans_logpdf: Callable | None = None,
):
    """Build ``run(key, ys, ref_path) -> (new_path, log_z)``: one
    conditional-SMC sweep with lane ``K-1`` pinned to ``ref_path``
    (leading axis T), returning a freshly drawn reference trajectory.
    With ``trans_logpdf`` the retained lane's ancestor is resampled
    each step (PGAS)."""
    k = n_particles

    def run(key: jax.Array, ys, ref_path):
        k_init, k_scan, k_pick = jax.random.split(key, 3)
        ref0 = _gather_lanes(ref_path, 0)
        xs0 = _set_lane(init_sampler(k_init, k), k - 1, ref0)
        lw0 = loglik(xs0, _gather_lanes(ys, 0))
        n_steps = jtu.tree_leaves(ys)[0].shape[0]

        def step(carry, inp):
            t, y_t = inp
            xs, lw = carry
            k_t = jax.random.fold_in(k_scan, t)
            k_anc, k_as, k_prop = jax.random.split(k_t, 3)

            # Free lanes: multinomial ancestors from the current
            # weights; retained lane: its own history, or an
            # ancestor-sampled one when the transition density is
            # available.
            anc_free = resample_indices(
                k_anc, lw, k - 1, method="multinomial"
            )
            ref_t = _gather_lanes(ref_path, t)
            if trans_logpdf is None:
                anc_ref = jnp.array(k - 1, jnp.int32)
            else:
                as_lw = lw + trans_logpdf(xs, ref_t)
                anc_ref = jax.random.categorical(k_as, as_lw)
            anc = jnp.concatenate(
                [anc_free, anc_ref[None].astype(anc_free.dtype)]
            )

            xs = _set_lane(
                propagate(k_prop, _gather_lanes(xs, anc)), k - 1, ref_t
            )
            lw = loglik(xs, y_t)
            return (xs, lw), (xs, anc, logsumexp(lw) - jnp.log(k))

        (xs_T, lw_T), (states, ancs, logz_incr) = lax.scan(
            step, (xs0, lw0),
            (jnp.arange(1, n_steps),
             jtu.tree_map(lambda v: v[1:], ys)),
        )
        log_z = (
            logsumexp(lw0) - jnp.log(k) + jnp.sum(logz_incr)
        )

        # Backward ancestral trace from a final draw.
        b_last = jax.random.categorical(k_pick, lw_T)

        def back(b, inp):
            xs_t, anc_t = inp
            x = _gather_lanes(xs_t, b)
            return anc_t[b], x

        b1, path_rev = lax.scan(
            back, b_last, (states, ancs), reverse=True
        )
        x0 = _gather_lanes(xs0, b1)
        path = jtu.tree_map(
            lambda h, t_: jnp.concatenate(
                [jnp.asarray(h)[None], t_], axis=0
            ),
            x0, path_rev,
        )
        return path, log_z

    return run


def particle_gibbs(
    init_sampler: Callable,
    propagate: Callable,
    loglik: Callable,
    n_particles: int,
    n_iters: int,
    trans_logpdf: Callable | None = None,
):
    """Build ``run(key, ys, init_path=None) -> ParticleGibbsResult``:
    ``n_iters`` conditional-SMC sweeps, each refreshing the reference
    trajectory (an MCMC kernel whose invariant distribution is the
    exact joint smoothing posterior). ``init_path``: optional starting
    trajectory (default: an unconditional bootstrap path from lane 0).
    """
    csmc = conditional_bootstrap_filter(
        init_sampler, propagate, loglik, n_particles, trans_logpdf
    )

    def run(key: jax.Array, ys, init_path=None):
        k_boot, k_sweeps = jax.random.split(key)
        if init_path is None:
            # Unconditioned warm start: prior rollouts, pick lane 0.
            n_steps = jtu.tree_leaves(ys)[0].shape[0]

            def roll(carry, t):
                xs = propagate(jax.random.fold_in(k_boot, t), carry)
                return xs, xs

            xs0 = init_sampler(jax.random.fold_in(k_boot, 0),
                               n_particles)
            _, states = lax.scan(
                roll, xs0, jnp.arange(1, n_steps)
            )
            init_path = jtu.tree_map(
                lambda h, t_: jnp.concatenate(
                    [jnp.asarray(h)[0][None], t_[:, 0]], axis=0
                ),
                xs0, states,
            )

        def sweep(path, i):
            new_path, log_z = csmc(
                jax.random.fold_in(k_sweeps, i), ys, path
            )
            return new_path, (new_path, log_z)

        final_path, (paths, log_zs) = lax.scan(
            sweep, init_path, jnp.arange(n_iters)
        )
        return ParticleGibbsResult(paths, log_zs, final_path)

    return run


# ---------------------------------------------------------------------------
# GFI-native particle Gibbs: conditional SMC over TRACES of a Scan model.
# ---------------------------------------------------------------------------


class TraceParticleGibbsResult(NamedTuple):
    paths: Any              # {addr: (n_iters, T, ...)} reference latents
    log_zs: jax.Array       # (n_iters,) per-sweep CSMC logZ estimates
    final_path: Any         # {addr: (T, ...)} last reference latents


def trace_csmc(
    scan_model,
    model_args: tuple,
    obs_address: str,
    observations: jax.Array,
    latent_addresses: tuple,
    n_particles: int,
    ancestor_sampling: bool = False,
):
    """Build ``run(key, ref) -> (new_ref, log_z)``: one conditional-SMC
    sweep over TRACES of a ``Scan`` model, lane ``K-1`` pinned to the
    reference latents ``ref = {addr: (T, ...)}``, drawing a fresh
    reference by a categorical pick from the final weights.

    GFI-native counterpart of :func:`conditional_bootstrap_filter` —
    the model is any ``Scan`` generative function recording an
    observation at ``(t, obs_address)`` and latents at
    ``(t, addr)`` for ``addr in latent_addresses``; no hand-written
    kernels. Each step: multinomial conditional resampling (free
    lanes draw ancestors from the weights, the retained lane keeps
    itself), prior refresh of the cloned futures (``Regenerate`` of
    steps > t-1 — the weight-0 refresh that makes the filter exactly
    the bootstrap CSMC, no shared-future coupling), then assimilation
    of observation t via an O(1) ``IndexRequest`` repair.

    ``ancestor_sampling=True`` (PGAS, Lindsten et al. 2014) resamples
    the retained lane's ancestor at every step — entirely through the
    GFI: the transition score of the reference's step-t latents
    against each lane's carry is one ``assess`` of the inner step
    gen fn (the shared observation term cancels in the categorical),
    and the ancestor splice is an ``Update`` of the chosen lane's
    trace pinning steps ≥ t back to the reference. Breaks path
    degeneracy so the sampler mixes at small N over long series.

    New scope relative to the reference: its only conditional-SMC
    artifact is the single-step retained importance lane
    (``/root/reference/src/genjax/_src/inference/smc.py:317-351``).
    """
    from genjax_xla.gfi.choice_map import ChoiceMap
    from genjax_xla.gfi.concepts import IndexRequest
    from genjax_xla.gfi.requests import Regenerate, Update
    from genjax_xla.gfi.selection import Selection

    k = n_particles
    n_steps = jtu.tree_leaves(observations)[0].shape[0]

    def pin_constraint(ref):
        chm = ChoiceMap.empty()
        for addr in latent_addresses:
            chm = chm | ChoiceMap.entry(
                ref[addr], jnp.arange(n_steps), addr
            )
        return chm

    def extract(tr):
        chm = tr.get_choices()
        return {addr: chm[:, addr] for addr in latent_addresses}

    inner_gf = scan_model.inner
    init_carry, scan_xs = model_args[0], model_args[1]

    def run(key: jax.Array, ref):
        k_init, k_pin, k_scan, k_pick = jax.random.split(key, 4)
        init_keys = jax.vmap(
            lambda i: jax.random.fold_in(k_init, i)
        )(jnp.arange(k))
        trs = jax.vmap(
            lambda kk: scan_model.simulate(kk, model_args)
        )(init_keys)

        # Pin lane K-1's latents to the reference trajectory.
        pin_full = pin_constraint(ref)
        tr_ref = _gather_lanes(trs, k - 1)
        tr_ref, _w, _rd, _bwd = tr_ref.update(k_pin, pin_full)
        trs = _set_lane(trs, k - 1, tr_ref)

        def step(carry, inp):
            t, obs_t = inp
            trs, lw, log_z = carry
            k_t = jax.random.fold_in(k_scan, t)
            k_anc, k_refresh, k_edit, k_as, k_splice = (
                jax.random.split(k_t, 5)
            )

            # Conditional multinomial resampling: free lanes draw
            # ancestors from the weights; the retained lane keeps
            # itself — or, under PGAS, swaps its history for an
            # ancestor drawn from lw + transition score to the
            # reference's step-t latents.
            if ancestor_sampling:
                chm_t = ChoiceMap.entry(obs_t, obs_address)
                for addr in latent_addresses:
                    chm_t = chm_t | ChoiceMap.entry(ref[addr][t], addr)
                xs_t = (
                    None if scan_xs is None
                    else jtu.tree_map(lambda v: v[t], scan_xs)
                )

                def lane_trans_score(tr):
                    prev = tr.get_inner_trace(
                        jnp.maximum(t - 1, 0)
                    ).get_retval()[0]
                    carry_in = jtu.tree_map(
                        lambda a, b: jnp.where(t == 0, jnp.asarray(a), b),
                        init_carry, prev,
                    )
                    score, _ = inner_gf.assess(chm_t, (carry_in, xs_t))
                    return score

                as_lw = lw + jax.vmap(lane_trans_score)(trs)
                b_as = jax.random.categorical(k_as, as_lw)
                tr_anc = _gather_lanes(trs, b_as)
                # Splice: the chosen ancestor's past + the reference's
                # future (steps >= t pinned back to ref).
                cstr = pin_full.filter(Selection.idx_above(t - 1))
                retained, _w2, _rd2, _bwd2 = tr_anc.update(
                    k_splice, cstr
                )
            else:
                retained = _gather_lanes(trs, k - 1)
            anc = resample_indices(k_anc, lw, k - 1, method="multinomial")
            new_trs = _gather_lanes(trs, anc)

            # Prior refresh of the cloned futures (steps > t-1): the
            # Regenerate weight is exactly 0 (nothing downstream of the
            # regenerated sites is constrained yet).
            req_fresh = Regenerate(Selection.idx_above(t - 1))

            def refresh(i, tr):
                pk = jax.random.fold_in(k_refresh, i)
                new_tr, _w, _rd, _bwd = tr.edit(pk, req_fresh)
                return new_tr

            new_trs = jax.vmap(refresh)(jnp.arange(k - 1), new_trs)
            trs = jtu.tree_map(
                lambda f, r: jnp.concatenate(
                    [f, jnp.asarray(r)[None]], axis=0
                ),
                new_trs, retained,
            )
            log_z = log_z + logsumexp(lw) - jnp.log(k)

            # Assimilate observation t on every lane (O(1) repair);
            # increment = log p(obs_t | x_t) after adding back the
            # discarded prior draw's site score.
            req_obs = IndexRequest(
                t, Update(ChoiceMap.entry(obs_t, obs_address))
            )

            def per_particle(i, tr):
                pk = jax.random.fold_in(k_edit, i)
                old_y_score = (
                    tr.get_inner_trace(t)
                    .get_inner_trace(obs_address)
                    .get_score()
                )
                new_tr, w, _rd, _bwd = tr.edit(pk, req_obs)
                return new_tr, w + old_y_score

            trs, lw = jax.vmap(per_particle)(jnp.arange(k), trs)
            return (trs, lw, log_z), None

        (trs, lw, log_z), _ = lax.scan(
            step,
            (trs, jnp.zeros(k), jnp.zeros(())),
            (jnp.arange(n_steps), observations),
        )
        log_z = log_z + logsumexp(lw) - jnp.log(k)

        b = jax.random.categorical(k_pick, lw)
        return extract(_gather_lanes(trs, b)), log_z

    return run


def trace_particle_gibbs(
    scan_model,
    model_args: tuple,
    obs_address: str,
    observations: jax.Array,
    latent_addresses: tuple,
    n_particles: int,
    n_iters: int,
    ancestor_sampling: bool = False,
):
    """Build ``run(key, init_ref=None) -> TraceParticleGibbsResult``:
    ``n_iters`` GFI-native conditional-SMC sweeps over a ``Scan``
    model (an MCMC kernel invariant for the exact joint smoothing
    posterior of the latents given the observations). ``init_ref``:
    optional ``{addr: (T, ...)}`` starting latents (default: one
    unconditional prior rollout)."""
    csmc = trace_csmc(
        scan_model, model_args, obs_address, observations,
        latent_addresses, n_particles,
        ancestor_sampling=ancestor_sampling,
    )

    def run(key: jax.Array, init_ref=None):
        k_boot, k_sweeps = jax.random.split(key)
        if init_ref is None:
            tr0 = scan_model.simulate(k_boot, model_args)
            chm0 = tr0.get_choices()
            init_ref = {
                addr: chm0[:, addr] for addr in latent_addresses
            }

        def sweep(ref, i):
            new_ref, log_z = csmc(
                jax.random.fold_in(k_sweeps, i), ref
            )
            return new_ref, (new_ref, log_z)

        final_ref, (paths, log_zs) = lax.scan(
            sweep, init_ref, jnp.arange(n_iters)
        )
        return TraceParticleGibbsResult(paths, log_zs, final_ref)

    return run
