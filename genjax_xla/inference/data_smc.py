"""Data-annealed SMC: condition a model on its observations one
constraint-group at a time (add-one-observation annealing), with adaptive
resampling and optional MCMC rejuvenation between assimilation steps —
for arbitrary models, entirely through the GFI.

The incremental weight of assimilating constraint group C_t on a particle
trace is ``log p(C_t | rest)``: computed as the Update edit weight plus the
prior draws' site scores at the newly-constrained addresses (the edit
weight alone is the density *ratio* new/old at those sites).

New scope (ROADMAP): complements ``tempered_smc`` (likelihood annealing)
and ``trace_particle_filter`` (scan-model time annealing with O(1)
repairs).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Sequence

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
from jax.scipy.special import logsumexp

from genjax_xla.gfi.choice_map import ChoiceMap
from genjax_xla.gfi.concepts import EditRequest
from genjax_xla.gfi.gfn import GenerativeFunction
from genjax_xla.gfi.requests import Update
from genjax_xla.core.compiler.taint import variant_leaf_mask
from genjax_xla.inference.smc import (
    effective_sample_size,
    resample_tree,
)

__all__ = ["data_annealed_smc", "DataSMCResult"]


class DataSMCResult(NamedTuple):
    traces: Any
    log_weights: jax.Array
    log_z: jax.Array
    ess_history: jax.Array
    accept_rate: jax.Array


def data_annealed_smc(
    model: GenerativeFunction,
    model_args: tuple,
    schedule: Sequence[ChoiceMap],
    n_particles: int,
    make_request: Callable[[], EditRequest] | None = None,
    n_moves: int = 0,
    ess_threshold: float = 0.5,
    resampling: str = "systematic",
):
    """Build ``run(key) -> DataSMCResult``.

    ``schedule``: the observation constraints, one group per assimilation
    step (static Python list — each group may constrain different
    addresses). ``make_request``/``n_moves``: optional rejuvenation moves
    (MH-corrected; the request weight is the log acceptance ratio at the
    full current posterior)."""
    def run(key: jax.Array) -> DataSMCResult:
        k_init, k_anneal = jax.random.split(key)
        init_keys = jax.vmap(
            lambda i: jax.random.fold_in(k_init, i)
        )(jnp.arange(n_particles))
        trs = jax.vmap(lambda k: model.simulate(k, model_args))(init_keys)

        # Ensemble-invariant leaves (model args and other key-free
        # data) skip the resampling expansion; choice leaves that the
        # schedule constrains later were key-sampled at build and stay
        # conservatively variant-marked (core/compiler/taint.py).
        invariant = jtu.tree_map(
            lambda variant: not variant,
            variant_leaf_mask(
                lambda k: model.simulate(k, model_args),
                jax.random.key(0),
            ),
        )

        lw = jnp.zeros(n_particles)
        log_z = jnp.zeros(())
        ess_hist = []
        accepts = []

        # The schedule is static: unroll assimilation steps in Python
        # (each step may have a different constraint structure).
        for t, constraint in enumerate(schedule):
            k_t = jax.random.fold_in(k_anneal, t)
            k_res, k_edit, k_move = jax.random.split(k_t, 3)
            sel = constraint.get_selection()

            # Adaptive resampling.
            ess = effective_sample_size(lw)
            ess_hist.append(ess)
            do_res = ess < ess_threshold * n_particles
            resampled = resample_tree(k_res, lw, trs, n_particles,
                                      resampling, invariant=invariant)
            trs = jtu.tree_map(
                lambda a, b: jnp.where(do_res, a, b), resampled, trs
            )
            log_z = jnp.where(
                do_res,
                log_z + logsumexp(lw) - jnp.log(n_particles),
                log_z,
            )
            lw = jnp.where(do_res, jnp.zeros_like(lw), lw)

            # Assimilate: constrain the group; incr = edit weight + the
            # discarded prior draws' site scores.
            def assimilate(i, tr):
                pk = jax.random.fold_in(k_edit, i)
                pk_e, pk_p = jax.random.split(pk)
                old_site_score = tr.project(pk_p, sel)
                new_tr, w, _rd, _bwd = tr.edit(
                    pk_e, Update(constraint)
                )
                return new_tr, w + old_site_score

            trs, incr = jax.vmap(assimilate)(
                jnp.arange(n_particles), trs
            )
            lw = lw + incr

            # Rejuvenation at the current partial posterior.
            if make_request is not None and n_moves > 0:
                acc_tot = jnp.zeros(())
                for m in range(n_moves):
                    mk = jax.random.fold_in(k_move, m)

                    def move(i, tr):
                        pk = jax.random.fold_in(mk, i)
                        pk_e, pk_a = jax.random.split(pk)
                        new_tr, w, _rd, _bwd = tr.edit(
                            pk_e, make_request()
                        )
                        accept = (
                            jnp.log(jax.random.uniform(pk_a, ())) < w
                        )
                        out = jtu.tree_map(
                            lambda a, b: jnp.where(accept, a, b),
                            new_tr, tr,
                        )
                        return out, accept

                    trs, acc = jax.vmap(move)(
                        jnp.arange(n_particles), trs
                    )
                    acc_tot = acc_tot + jnp.mean(acc)
                accepts.append(acc_tot / n_moves)
            else:
                accepts.append(jnp.zeros(()))

        log_z = log_z + logsumexp(lw) - jnp.log(n_particles)
        return DataSMCResult(
            trs, lw, log_z,
            jnp.stack(ess_hist), jnp.stack(accepts),
        )

    return run
