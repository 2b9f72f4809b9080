"""Hamiltonian Monte Carlo as an edit request: gradient of ``assess`` with
respect to a selection of choices, Gaussian momenta, leapfrog integration
under ``lax.scan``, and the MH alpha ratio as the edit weight.

Parity target: ``/root/reference/src/genjax/_src/inference/requests/hmc.py``
(``selection_gradient`` :49-96, momenta :100-130, leapfrog scan :170-194,
alpha weight :196-203, ``SafeHMC`` :214-223).

Notes: thanks to eager (pruning) ``ChoiceMap.filter``, the position /
momentum pytrees carry *only* the selected leaves — no masked dead weight in
the leapfrog — and the whole trajectory is one ``lax.scan`` whose body fuses
into a single XLA computation.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
from jax import lax

from genjax_xla.core.pytree import Pytree
from genjax_xla.core.compiler.interpreters.incremental import Diff
from genjax_xla.core.typing import static_check_supports_grad
from genjax_xla.gfi.choice_map import ChoiceMap
from genjax_xla.gfi.concepts import Argdiffs, EditRequest, Retdiff, Weight
from genjax_xla.gfi.gfn import Trace
from genjax_xla.gfi.requests import DiffAnnotate, Update
from genjax_xla.gfi.selection import Selection

__all__ = ["HMC", "SafeHMC", "selection_gradient"]


def _grad_unzip(tree):
    """Split a pytree into (differentiable, other) by leaf dtype."""
    grad_tree = jtu.tree_map(
        lambda v: v if static_check_supports_grad(v) else None, tree
    )
    nongrad_tree = jtu.tree_map(
        lambda v: None if static_check_supports_grad(v) else v, tree
    )
    return grad_tree, nongrad_tree


def _grad_zip(grad_tree, nongrad_tree):
    return jtu.tree_map(
        lambda v1, v2: v2 if v1 is None else v1,
        grad_tree,
        nongrad_tree,
        is_leaf=lambda x: x is None,
    )


def selection_gradient(selection: Selection, trace: Trace[Any],
                       args: tuple) -> tuple[ChoiceMap, ChoiceMap]:
    """Returns ``(selected_values, d score / d selected_values)`` as
    choice-map pytrees of identical structure.

    Parity: reference ``hmc.py:49-96``."""
    chm = trace.get_choices()
    selected = chm.filter(selection)
    complement = chm.filter(~selection)
    grad_tree, nongrad_tree = _grad_unzip(selected)
    gen_fn = trace.get_gen_fn()

    def differentiable_assess(grad_tree):
        zipped = _grad_zip(grad_tree, nongrad_tree)
        score, _ = gen_fn.assess(zipped | complement, args)
        return score

    gradient = jax.grad(differentiable_assess)(grad_tree)
    values = _grad_zip(grad_tree, nongrad_tree)
    def zero_fill(g, v):
        if g is not None:
            return g
        if v is None:  # structural None (e.g. canonical Indexed.idx)
            return None
        return jnp.zeros_like(jnp.asarray(v))

    grads = jtu.tree_map(
        zero_fill, gradient, values, is_leaf=lambda x: x is None
    )
    return values, grads


def _momenta_score(momenta) -> jax.Array:
    leaves = jtu.tree_leaves(momenta)
    return sum(
        (jnp.sum(-0.5 * jnp.square(m) - 0.5 * jnp.log(2.0 * jnp.pi))
         for m in leaves),
        start=jnp.zeros(()),
    )


def _sample_momenta(key, template):
    leaves, treedef = jtu.tree_flatten(template)
    momenta = [
        jax.random.normal(jax.random.fold_in(key, i), jnp.shape(v))
        for i, v in enumerate(leaves)
    ]
    tree = jtu.tree_unflatten(treedef, momenta)
    return tree, _momenta_score(tree)


@Pytree.dataclass
class HMC(EditRequest):
    """Leapfrog-integrate Hamilton's equations for the selected choices
    (Neal 2011, eqs 5.18-5.20); the edit weight is the log MH alpha ratio.

    Parity: reference ``hmc.py:138-211``."""

    selection: Selection
    eps: Any
    L: int = Pytree.static(default=10)

    def edit(self, key: jax.Array, tr: Trace[Any], argdiffs: Argdiffs):
        assert Diff.static_check_no_change(argdiffs), (
            "HMC requires unchanged arguments (use SafeHMC semantics)."
        )
        args = Diff.tree_primal(argdiffs)
        original_score = tr.get_score()
        values, gradients = selection_gradient(self.selection, tr, args)
        key, mom_key = jax.random.split(key)
        momenta, original_momenta_score = _sample_momenta(mom_key, values)

        def leapfrog(carry, i):
            trace, values, gradients, momenta = carry
            momenta = jtu.tree_map(
                lambda m, g: m + (self.eps / 2) * g, momenta, gradients
            )
            values = jtu.tree_map(
                lambda v, m: v + self.eps * m, values, momenta
            )
            step_key = jax.random.fold_in(key, i)
            new_trace, _, _, _ = Update(values).edit(step_key, trace,
                                                     argdiffs)
            values, gradients = selection_gradient(
                self.selection, new_trace, args
            )
            momenta = jtu.tree_map(
                lambda m, g: m + (self.eps / 2) * g, momenta, gradients
            )
            return (new_trace, values, gradients, momenta), None

        (final_trace, _, _, final_momenta), _ = lax.scan(
            leapfrog,
            (tr, values, gradients, momenta),
            jnp.arange(1, self.L + 1),
            length=self.L,
        )

        final_momenta_score = _momenta_score(
            jtu.tree_map(lambda m: -m, final_momenta)
        )
        alpha = (
            final_trace.get_score()
            - original_score
            + final_momenta_score
            - original_momenta_score
        )
        retdiff = Diff.unknown_change(final_trace.get_retval())
        return final_trace, alpha, retdiff, HMC(self.selection, self.eps,
                                                self.L)


def SafeHMC(selection: Selection, eps, L: int = 10) -> DiffAnnotate:
    """HMC wrapped with a retdiff NoChange assertion.

    Parity: reference ``hmc.py:214-223``."""

    def retdiff_assertion(retdiff: Retdiff):
        assert Diff.static_check_no_change(retdiff)
        return retdiff

    return HMC(selection, eps, L).map(retdiff_assertion)
