"""SMC samplers: tempered sequential Monte Carlo with MCMC rejuvenation —
anneal from the prior to the posterior along a temperature ladder, with
ensemble-wide reweighting / adaptive resampling / rejuvenation moves per
rung, all inside one ``lax.scan`` (new scope: the reference has neither
resampling nor move steps, SURVEY §2.2).

Built generically on the GFI. The key identity: for any edit request whose
weight is the full-posterior log-ratio (``Regenerate``, ``Rejuvenate``,
``HMC`` — all reversible moves), the correct acceptance for the *tempered*
target π_β ∝ p(z)·L(z)^β is

    α_β = w_request + (β − 1)·Δ loglik,

where ``loglik = trace.project(constrained addresses)`` — because
``w_request`` is Δlog p_full (+ kinetic terms for HMC) and tempering only
rescales the likelihood factor.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
from jax import lax
from jax.scipy.special import logsumexp

from genjax_xla.core.compiler.taint import variant_leaf_mask
from genjax_xla.gfi.choice_map import ChoiceMap
from genjax_xla.gfi.concepts import EditRequest
from genjax_xla.inference.smc import effective_sample_size, resample_tree
from genjax_xla.inference.sp import Target

__all__ = ["annealed_importance_sampling", "tempered_smc",
           "waste_free_tempered_smc", "TemperedSMCResult"]


class TemperedSMCResult(NamedTuple):
    traces: Any           # vectorized particle traces (leading axis K)
    log_weights: jax.Array
    log_z: jax.Array      # estimate of log Z = log p(observations)
    accept_rate: jax.Array  # mean rejuvenation acceptance per rung



def _select_accept(accept, new_tr, tr, inv_mask):
    """Per-leaf MH accept select that skips ensemble-invariant leaves
    (their values are identical in both traces — edits preserve
    constrained choice values — so selecting moves wide constant data
    for nothing; see core/compiler/taint.py)."""
    leaves_n, td = jtu.tree_flatten(new_tr)
    leaves_o = jtu.tree_leaves(tr)
    inv = jtu.tree_leaves(inv_mask)
    out = [
        o if iv else jnp.where(accept, nw, o)
        for nw, o, iv in zip(leaves_n, leaves_o, inv)
    ]
    return jtu.tree_unflatten(td, out)


def tempered_smc(
    target: Target,
    n_particles: int,
    n_temps: int = 20,
    make_request: Callable[[], EditRequest] | None = None,
    n_moves: int = 1,
    ess_threshold: float = 0.5,
    resampling: str = "systematic",
):
    """Build ``run(key) -> TemperedSMCResult`` annealing π_β from β=0
    (prior) to β=1 (posterior) over a linear ladder of ``n_temps`` rungs.

    ``make_request``: a thunk returning the rejuvenation move request
    (default: ``Regenerate`` of all unconstrained addresses).
    ``ess_threshold=0.0`` statically elides the resample branch from
    the compiled program (the AIS case — see
    :func:`annealed_importance_sampling`)."""
    lik_sel = target.constraint.get_selection()

    if make_request is None:
        from genjax_xla.gfi.requests import Regenerate

        unconstrained = ~lik_sel

        def make_request():
            return Regenerate(unconstrained)

    betas = jnp.linspace(0.0, 1.0, n_temps + 1)

    def loglik_of(key, tr):
        return tr.get_gen_fn().project(key, tr, lik_sel)

    def run(key: jax.Array) -> TemperedSMCResult:
        k_init, k_anneal = jax.random.split(key)
        init_keys = jax.vmap(
            lambda i: jax.random.fold_in(k_init, i)
        )(jnp.arange(n_particles))
        trs, _ = jax.vmap(
            lambda k: target.importance(k, ChoiceMap.empty())
        )(init_keys)
        logliks = jax.vmap(lambda k, t: loglik_of(k, t))(init_keys, trs)

        # Ensemble-invariant leaves (e.g. the constrained observation
        # values each trace carries, broadcast per particle) need no
        # resampling — and they are the WIDE leaves, so skipping them
        # removes most of the resample's data movement (taint.py
        # module docstring; measured 56 of 60 ms at 512k particles on
        # a 64-point likelihood).
        def _per_particle(k):
            tr, _ = target.importance(k, ChoiceMap.empty())
            return tr, loglik_of(k, tr)

        invariant = jtu.tree_map(
            lambda variant: not variant,
            variant_leaf_mask(_per_particle, jax.random.key(0)),
        )

        def rung(carry, inp):
            t, beta_prev, beta = inp
            trs, logliks, lw, log_z = carry
            k_t = jax.random.fold_in(k_anneal, t)
            k_res, k_move = jax.random.split(k_t)

            # Reweight to the next temperature.
            lw = lw + (beta - beta_prev) * logliks

            # Adaptive resampling. ``ess_threshold`` is static: at 0.0
            # (the AIS degenerate case) the gate could never fire, so
            # the cond — and with it the resample machinery and its
            # collectives — is not built at all (ADVICE r4: a traced
            # ``ess < 0.0`` cond still compiles both branches).
            if ess_threshold > 0.0:
                ess = effective_sample_size(lw)

                def do_resample(args):
                    trs, logliks, lw, log_z = args
                    # Resample traces and their cached logliks JOINTLY —
                    # a resampled trace must carry its own loglik, or
                    # the tempered MH alpha and the next rung's reweight
                    # use stale values (biasing posterior and log_z).
                    trs, logliks = resample_tree(
                        k_res, lw, (trs, logliks), n_particles,
                        resampling, invariant=invariant,
                    )
                    log_z = log_z + logsumexp(lw) - jnp.log(n_particles)
                    return trs, logliks, jnp.zeros_like(lw), log_z

                trs, logliks, lw, log_z = lax.cond(
                    ess < ess_threshold * n_particles,
                    do_resample,
                    lambda args: args,
                    (trs, logliks, lw, log_z),
                )

            # Rejuvenation moves at temperature `beta`.
            def one_move(carry, m):
                trs, logliks, acc = carry
                move_key = jax.random.fold_in(k_move, m)

                def per_particle(i, tr, loglik):
                    pk = jax.random.fold_in(move_key, i)
                    pk_edit, pk_lik, pk_acc = jax.random.split(pk, 3)
                    new_tr, w, _rd, _bwd = tr.edit(pk_edit, make_request())
                    new_loglik = loglik_of(pk_lik, new_tr)
                    alpha = w + (beta - 1.0) * (new_loglik - loglik)
                    accept = (
                        jnp.log(jax.random.uniform(pk_acc, ())) < alpha
                    )
                    out_tr = _select_accept(
                        accept, new_tr, tr, invariant[0]
                    )
                    out_lik = jnp.where(accept, new_loglik, loglik)
                    return out_tr, out_lik, accept

                trs, logliks, accepts = jax.vmap(per_particle)(
                    jnp.arange(n_particles), trs, logliks
                )
                return (trs, logliks, acc + jnp.mean(accepts)), None

            (trs, logliks, acc), _ = lax.scan(
                one_move, (trs, logliks, jnp.zeros(())), jnp.arange(n_moves)
            )
            return (trs, logliks, lw, log_z), acc / n_moves

        init_carry = (
            trs, logliks, jnp.zeros(n_particles), jnp.zeros(())
        )
        (trs, logliks, lw, log_z), accs = lax.scan(
            rung,
            init_carry,
            (jnp.arange(n_temps), betas[:-1], betas[1:]),
        )
        log_z = log_z + logsumexp(lw) - jnp.log(n_particles)
        return TemperedSMCResult(trs, lw, log_z, accs)

    return run


def waste_free_tempered_smc(
    target: Target,
    n_resampled: int,
    n_moves_per_particle: int,
    n_temps: int = 20,
    make_request: Callable[[], EditRequest] | None = None,
    resampling: str = "systematic",
):
    """Waste-free SMC (Dau & Chopin 2022) on the temperature ladder: at
    every rung, resample M = ``n_resampled`` particles, push each through
    P−1 = ``n_moves_per_particle``−1 MCMC steps, and keep ALL M·P visited
    states as the next (equally weighted) ensemble of N = M·P particles —
    no rejuvenation work is discarded.

    Returns ``run(key) -> TemperedSMCResult`` with N-particle outputs."""
    m, p = n_resampled, n_moves_per_particle
    n_particles = m * p
    lik_sel = target.constraint.get_selection()

    if make_request is None:
        from genjax_xla.gfi.requests import Regenerate

        unconstrained = ~lik_sel

        def make_request():
            return Regenerate(unconstrained)

    betas = jnp.linspace(0.0, 1.0, n_temps + 1)

    def loglik_of(key, tr):
        return tr.get_gen_fn().project(key, tr, lik_sel)

    def run(key: jax.Array) -> TemperedSMCResult:
        k_init, k_anneal = jax.random.split(key)
        init_keys = jax.vmap(
            lambda i: jax.random.fold_in(k_init, i)
        )(jnp.arange(n_particles))
        trs, _ = jax.vmap(
            lambda k: target.importance(k, ChoiceMap.empty())
        )(init_keys)
        logliks = jax.vmap(loglik_of)(init_keys, trs)

        def _per_particle(k):
            tr, _ = target.importance(k, ChoiceMap.empty())
            return tr, loglik_of(k, tr)

        # Skip resampling of ensemble-invariant (constraint) leaves —
        # see tempered_smc above / core/compiler/taint.py.
        invariant = jtu.tree_map(
            lambda variant: not variant,
            variant_leaf_mask(_per_particle, jax.random.key(0)),
        )

        def rung(carry, inp):
            t, beta_prev, beta = inp
            trs, logliks, lw, log_z = carry
            k_t = jax.random.fold_in(k_anneal, t)
            k_res, k_move = jax.random.split(k_t)

            # Reweight to the next temperature, then ALWAYS resample M
            # starters and absorb the mass (waste-free scheme).
            lw = lw + (beta - beta_prev) * logliks
            log_z = log_z + logsumexp(lw) - jnp.log(n_particles)
            starters = resample_tree(
                k_res, lw, (trs, logliks), m, resampling,
                invariant=invariant,
            )
            s_trs, s_liks = starters

            # Each starter runs a P-1-step chain at temperature beta;
            # every visited state (incl. the starter) joins the ensemble.
            def one_chain(i, tr, loglik):
                ck = jax.random.fold_in(k_move, i)

                def mh_step(carry, j):
                    tr, loglik, acc = carry
                    pk = jax.random.fold_in(ck, j)
                    pk_e, pk_l, pk_a = jax.random.split(pk, 3)
                    new_tr, w, _rd, _bwd = tr.edit(pk_e, make_request())
                    new_loglik = loglik_of(pk_l, new_tr)
                    alpha = w + (beta - 1.0) * (new_loglik - loglik)
                    accept = (
                        jnp.log(jax.random.uniform(pk_a, ())) < alpha
                    )
                    out_tr = _select_accept(
                        accept, new_tr, tr, invariant[0]
                    )
                    out_lik = jnp.where(accept, new_loglik, loglik)
                    return (out_tr, out_lik, acc + accept), (out_tr,
                                                            out_lik)

                (_, _, acc), (chain_trs, chain_liks) = lax.scan(
                    mh_step, (tr, loglik, jnp.zeros(())),
                    jnp.arange(p - 1),
                )
                # Prepend the starter state.
                all_trs = jtu.tree_map(
                    lambda s, c: jnp.concatenate(
                        [jnp.asarray(s)[None], c], axis=0
                    ),
                    tr, chain_trs,
                )
                all_liks = jnp.concatenate([loglik[None], chain_liks])
                return all_trs, all_liks, acc / jnp.maximum(p - 1, 1)

            chains_trs, chains_liks, accs = jax.vmap(one_chain)(
                jnp.arange(m), s_trs, s_liks
            )
            # (M, P, ...) -> (N, ...)
            trs = jtu.tree_map(
                lambda v: v.reshape((n_particles,) + v.shape[2:]),
                chains_trs,
            )
            logliks = chains_liks.reshape((n_particles,))
            return (trs, logliks, jnp.zeros(n_particles), log_z), jnp.mean(
                accs
            )

        init_carry = (trs, logliks, jnp.zeros(n_particles), jnp.zeros(()))
        (trs, logliks, lw, log_z), accs = lax.scan(
            rung, init_carry, (jnp.arange(n_temps), betas[:-1], betas[1:])
        )
        log_z = log_z + logsumexp(lw) - jnp.log(n_particles)
        return TemperedSMCResult(trs, lw, log_z, accs)

    return run


def annealed_importance_sampling(
    target: Target,
    n_particles: int,
    n_temps: int = 20,
    make_request: "Callable[[], EditRequest] | None" = None,
    n_moves: int = 1,
):
    """Annealed importance sampling (Neal 2001): ``tempered_smc``'s
    ladder with resampling DISABLED, so every particle is an independent
    AIS run and the weights are the classic AIS incremental products —
    log Z̄ is unbiased in Z (not just consistent), per-particle weights
    are exchangeable (no interaction), and the whole ensemble is
    embarrassingly parallel (shard the particle axis with no resampling
    collectives at all).

    AIS *is* a degenerate SMC sampler — one code path, zero duplication:
    ``ess_threshold=0`` is special-cased in ``tempered_smc`` so the
    resample cond (and its collectives) is never even built into the
    program — the no-collective property holds in the compiled HLO,
    not just behaviorally. Prefer
    ``tempered_smc`` when weight degeneracy matters (it usually does
    past a few rungs); prefer AIS for evidence estimation with many
    independent replicas or when the no-collective property is the
    point. Returns the same ``run(key) -> TemperedSMCResult``."""
    return tempered_smc(
        target, n_particles, n_temps=n_temps, make_request=make_request,
        n_moves=n_moves, ess_threshold=0.0,
    )
