"""Parallel tempering (replica exchange) MCMC over a temperature
ladder, built on the GFI edit machinery.

New scope relative to the reference (it has no MCMC drivers at all;
SURVEY §2.2): R replicas target π_β ∝ p(z)·L(z)^β for an ascending
β ladder ending at 1 (the posterior). Each step runs a within-
temperature MH move per replica — reusing the tempered-acceptance
identity from ``smc_sampler``: for any reversible edit request whose
weight is the full-posterior log-ratio, ``α_β = w + (β−1)·Δloglik`` —
then exchanges adjacent replicas with the standard swap acceptance
``log α = (β_{r+1} − β_r)·(loglik_r − loglik_{r+1})`` (prior factors
cancel; hot states with better likelihood migrate toward the cold
chain, which is what lets the cold chain cross energy barriers local
moves cannot).

Shape: the replica axis is a plain leading vmap axis and
the swap phase is expressed with ``roll``-and-select (no data-
dependent gathers), so the whole sampler is one ``lax.scan`` whose
replica axis shards over a mesh unchanged — swaps lower to
neighbor-``ppermute`` collectives under GSPMD. Even/odd pair phases
alternate per step (deterministic, standard DEO-style sweep).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
from jax import lax

from genjax_xla.gfi.choice_map import ChoiceMap
from genjax_xla.gfi.concepts import EditRequest
from genjax_xla.inference.sp import Target

__all__ = ["ParallelTemperingResult", "parallel_tempering"]


class ParallelTemperingResult(NamedTuple):
    traces: Any             # final replica traces (leading axis R)
    samples: Any            # collected cold-chain values (n_keep, ...)
    accept_rate: jax.Array  # (R,) within-temperature MH acceptance
    swap_rate: jax.Array    # (R-1,) adjacent-pair swap acceptance


def _bcast(mask, leaf):
    return mask.reshape(mask.shape + (1,) * (jnp.ndim(leaf) - 1))


def _pair_swap(tree, leader_acc):
    """Swap entries r <-> r+1 of every leaf's leading axis wherever
    ``leader_acc[r]`` is True (leaders are non-overlapping by
    construction: even/odd phases). Pure roll + select."""
    follower = jnp.roll(leader_acc, 1)

    def leafwise(v):
        v = jnp.asarray(v)
        down = jnp.roll(v, -1, axis=0)   # value of replica r+1
        up = jnp.roll(v, 1, axis=0)      # value of replica r-1
        out = jnp.where(_bcast(leader_acc, v), down, v)
        return jnp.where(_bcast(follower, v), up, out)

    return jtu.tree_map(leafwise, tree)


def parallel_tempering(
    target: Target,
    betas,
    make_request: Callable[[], EditRequest] | None = None,
    n_moves: int = 1,
):
    """Build ``run(key, n_steps, collect=None, burn_in=0) ->
    ParallelTemperingResult``.

    ``betas``: ascending temperature ladder; the LAST entry must be 1.0
    (the cold chain whose samples are collected). An int builds a
    linear ladder of that many rungs from 0 to 1.
    ``make_request``: thunk returning the within-temperature move
    (default ``Regenerate`` of all unconstrained addresses);
    ``n_moves`` MH applications per replica per step."""
    if isinstance(betas, int):
        betas = jnp.linspace(0.0, 1.0, betas)
    betas = jnp.asarray(betas, jnp.float32)
    n_rungs = betas.shape[0]
    assert n_rungs >= 2, "parallel tempering needs >= 2 rungs"
    lik_sel = target.constraint.get_selection()

    if make_request is None:
        from genjax_xla.gfi.requests import Regenerate

        unconstrained = ~lik_sel

        def make_request():
            return Regenerate(unconstrained)

    def loglik_of(key, tr):
        return tr.get_gen_fn().project(key, tr, lik_sel)

    # Pair-leader masks for the two sweep phases: even phase pairs
    # (0,1),(2,3),..., odd phase pairs (1,2),(3,4),.... The last rung is
    # never a leader (no partner above it).
    r_iota = jnp.arange(n_rungs)
    leader_masks = jnp.stack([
        (r_iota % 2 == p) & (r_iota < n_rungs - 1) for p in (0, 1)
    ])                                              # (2, R)
    dbeta_up = jnp.concatenate([betas[1:] - betas[:-1], jnp.zeros(1)])

    def run(key: jax.Array, n_steps: int, *,
            collect: Callable[[Any], Any] | None = None,
            burn_in: int = 0) -> ParallelTemperingResult:
        k_init, k_steps = jax.random.split(key)
        init_keys = jax.vmap(
            lambda i: jax.random.fold_in(k_init, i)
        )(r_iota)
        trs, _ = jax.vmap(
            lambda k: target.importance(k, ChoiceMap.empty())
        )(init_keys)
        logliks = jax.vmap(loglik_of)(init_keys, trs)

        def step(carry, t):
            trs, logliks = carry
            k_t = jax.random.fold_in(k_steps, t)
            k_move, k_swap = jax.random.split(k_t)

            # -- Within-temperature MH moves, vmapped over replicas. --
            def one_sweep(carry, m):
                trs, logliks, acc = carry
                mk = jax.random.fold_in(k_move, m)

                def per_replica(r, beta, tr, loglik):
                    pk = jax.random.fold_in(mk, r)
                    pk_e, pk_l, pk_a = jax.random.split(pk, 3)
                    new_tr, w, _rd, _bwd = tr.edit(pk_e, make_request())
                    new_loglik = loglik_of(pk_l, new_tr)
                    alpha = w + (beta - 1.0) * (new_loglik - loglik)
                    accept = (
                        jnp.log(jax.random.uniform(pk_a, ())) < alpha
                    )
                    out_tr = jtu.tree_map(
                        lambda nw, o: jnp.where(accept, nw, o),
                        new_tr, tr,
                    )
                    out_lik = jnp.where(accept, new_loglik, loglik)
                    return out_tr, out_lik, accept

                trs, logliks, accepts = jax.vmap(per_replica)(
                    r_iota, betas, trs, logliks
                )
                return (trs, logliks, acc + accepts), None

            (trs, logliks, acc), _ = lax.scan(
                one_sweep, (trs, logliks, jnp.zeros(n_rungs)),
                jnp.arange(n_moves),
            )

            # -- Replica-exchange phase (even t: even pairs; odd t:
            # odd pairs). log α = Δβ · (loglik_r − loglik_{r+1}). -----
            leader = leader_masks[t % 2]
            ll_next = jnp.roll(logliks, -1)
            log_alpha = dbeta_up * (logliks - ll_next)
            us = jax.random.uniform(k_swap, (n_rungs,))
            leader_acc = leader & (jnp.log(us) < log_alpha)
            trs = _pair_swap(trs, leader_acc)
            logliks = _pair_swap(logliks, leader_acc)

            cold = jtu.tree_map(lambda v: v[-1], trs)
            out = collect(cold) if collect is not None else None
            swap_stats = jnp.where(leader[:-1], leader_acc[:-1], jnp.nan)
            return (trs, logliks), (out, acc / n_moves, swap_stats)

        (trs, _), (samples, accs, swaps) = lax.scan(
            step, (trs, logliks), jnp.arange(n_steps)
        )
        if burn_in and samples is not None:
            samples = jtu.tree_map(lambda v: v[burn_in:], samples)
        # Swap attempts alternate phases: average over the attempts only.
        # A rung pair whose phase never ran (e.g. odd pairs when
        # n_steps == 1) has zero attempts — report NaN for it without
        # tripping numpy's all-NaN-slice warning.
        attempted = jnp.isfinite(swaps)
        n_att = jnp.sum(attempted, axis=0)
        swap_sum = jnp.sum(jnp.where(attempted, swaps, 0.0), axis=0)
        swap_rate = jnp.where(
            n_att > 0, swap_sum / jnp.maximum(n_att, 1), jnp.nan
        )
        return ParallelTemperingResult(
            trs, samples, jnp.mean(accs, axis=0), swap_rate
        )

    return run
