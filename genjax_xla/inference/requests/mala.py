"""Metropolis-adjusted Langevin (MALA) as an edit request.

One Euler step of the overdamped Langevin diffusion on the selected
choices — ``x' = x + (eps²/2)·∇log p(x) + eps·ξ`` — with the exact
asymmetric-proposal MH correction returned as the edit weight, so
``inference.mcmc.mh`` turns it into a valid kernel unchanged.

New scope relative to the reference (its only gradient-based move is
HMC, ``/root/reference/src/genjax/_src/inference/requests/hmc.py``):
MALA is the one-leapfrog-step workhorse for tall vmapped chain
ensembles — a single gradient + ``Update`` per step keeps the
per-step XLA program small, which matters when thousands of chains run
inside one program (benchmark config 2 regime).

Reuses ``selection_gradient`` (gradient of ``assess`` w.r.t. a
selection of choices, reference parity ``hmc.py:49-96``); per-leaf
noise keys via ``fold_in`` for layout independence (repo convention).
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
import jax.tree_util as jtu

from genjax_xla.core.compiler.interpreters.incremental import Diff
from genjax_xla.core.pytree import Pytree
from genjax_xla.gfi.concepts import Argdiffs, EditRequest
from genjax_xla.gfi.requests import Update
from genjax_xla.gfi.selection import Selection
from genjax_xla.inference.requests.hmc import selection_gradient

__all__ = ["MALA"]


def _tree_normal(key, template):
    leaves, treedef = jtu.tree_flatten(template)
    noise = [
        jax.random.normal(jax.random.fold_in(key, i), jnp.shape(v))
        for i, v in enumerate(leaves)
    ]
    return jtu.tree_unflatten(treedef, noise)


def _log_q(y, mean, eps) -> jax.Array:
    """log N(y; mean, eps²·I) summed over the pytree, dropping the
    normalizer (identical for forward and backward, cancels in α)."""
    sq = jtu.tree_map(
        lambda a, b: jnp.sum(jnp.square((a - b) / eps)), y, mean
    )
    return -0.5 * sum(jtu.tree_leaves(sq), start=jnp.zeros(()))


@Pytree.dataclass
class MALA(EditRequest):
    """Langevin proposal + exact MH correction on ``selection``.

    ``eps`` is the integrator step size (the proposal is
    ``N(x + (eps²/2)·∇log p, eps²·I)`` leafwise). The edit weight is
    the full log acceptance ratio
    ``Δscore + log q(x|x') − log q(x'|x)``; the backward request is the
    same ``MALA`` (self-inverse family, like ``HMC``)."""

    selection: Selection
    eps: Any

    def edit(self, key: jax.Array, tr, argdiffs: Argdiffs):
        assert Diff.static_check_no_change(argdiffs), (
            "MALA requires unchanged arguments."
        )
        args = Diff.tree_primal(argdiffs)
        values, grads = selection_gradient(self.selection, tr, args)
        key, noise_key = jax.random.split(key)
        xi = _tree_normal(noise_key, values)

        half = 0.5 * self.eps * self.eps
        fwd_mean = jtu.tree_map(
            lambda v, g_: v + half * g_, values, grads
        )
        proposed = jtu.tree_map(
            lambda m, z: m + self.eps * z, fwd_mean, xi
        )
        new_trace, _, retdiff, _ = Update(proposed).edit(
            key, tr, argdiffs
        )
        _, new_grads = selection_gradient(
            self.selection, new_trace, args
        )
        bwd_mean = jtu.tree_map(
            lambda v, g_: v + half * g_, proposed, new_grads
        )
        alpha = (
            new_trace.get_score()
            - tr.get_score()
            + _log_q(values, bwd_mean, self.eps)
            - _log_q(proposed, fwd_mean, self.eps)
        )
        return new_trace, alpha, retdiff, MALA(self.selection, self.eps)
