"""Posterior predictive sampling: push posterior draws back through the
model.

Given a :class:`Target` and the latent draws an inference run returned
(``run_nuts``'s (chains, samples)-leading choice maps, ``run_svgd``'s
(particles,) ensembles, SMC particle choices), ``posterior_predictive``
regenerates the model once per draw with the latents CONSTRAINED to that
draw — the unconstrained (observed) addresses are then sampled from
their conditional distribution given those latents, which is exactly the
posterior predictive. One ``generate`` per draw, vmapped over the sample
axes, so a (1024, 500)-draw predictive is one XLA program.

New scope relative to the reference (no predictive helper there; its
cookbook re-simulates by hand).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from genjax_xla.gfi.choice_map import ChoiceMap
from genjax_xla.inference.sp import Target

__all__ = ["posterior_predictive"]


def posterior_predictive(
    target: Target,
    draws: ChoiceMap,
    key: jax.Array,
    sample_ndims: int = 2,
):
    """Sample the observed addresses given posterior latent ``draws``.

    ``draws``: a choice map of LATENT choices whose value leaves all
    carry ``sample_ndims`` leading sample axes (2 for ``run_nuts``'s
    (chains, samples) on flat-site models, 1 for
    ``run_svgd``/particle ensembles). For latents under Scan/Vmap
    combinators, rebuild the draws with sample axes leading on every
    leaf (``run_nuts`` returns those sites lane-leading) — e.g.
    ``C["xs"].set(chms["xs", lane])``-style per-address assembly.

    Returns ``(choices, retvals)``: the full per-draw model choices
    (latents as given, observed addresses freshly sampled — query them
    by address) and the per-draw return values, both with the same
    leading sample axes.

    Keys fold in the flattened draw index, so results are independent of
    how the sample axes are blocked or sharded (the package's RNG
    layout-independence convention)."""
    leaves = jax.tree_util.tree_leaves(draws)
    if not leaves:
        raise ValueError("posterior_predictive: draws has no choices.")
    lead = jnp.shape(leaves[0])[:sample_ndims]
    for lf in leaves:
        if jnp.shape(lf)[:sample_ndims] != lead:
            raise ValueError(
                "posterior_predictive: every draws leaf must share the "
                f"leading sample axes {lead}; got a leaf of shape "
                f"{jnp.shape(lf)}. For Scan/Vmap latents rebuild the "
                "draws sample-leading (see docstring)."
            )

    n_total = 1
    for d in lead:
        n_total *= int(d)
    keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(
        jnp.arange(n_total)
    ).reshape(*lead)

    def one(draw, k):
        tr, _ = target.p.generate(k, draw, target.args)
        return tr.get_choices(), tr.get_retval()

    f = one
    for _ in range(sample_ndims):
        f = jax.vmap(f)
    return f(draws, keys)
