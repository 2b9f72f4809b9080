"""Key-dependency (taint) analysis over jaxprs.

``variant_leaf_mask(fn, *args, argnum=0)`` answers, per output leaf of
``fn``: *can this value depend on argument ``argnum``?* — by staging
``fn`` to a jaxpr and propagating a taint mark from that argument's
input variables through every equation (conservatively: any tainted
operand taints every output of the equation, including through
higher-order primitives' inner jaxprs, which are not descended into).

Why it exists (cost model): inference ensembles built by
``vmap(lambda key: …)(keys)`` contain leaves that do NOT depend on the
per-particle key — e.g. the constrained observation values a trace
carries, broadcast to ``(particles, obs_dim)``. Those leaves are
bitwise identical across particles, so resampling them is pure data
movement — and it is *wide* data (a 64-point observation makes the
ancestor expansion move 64× the latent state: measured 56 ms of a
60 ms tempered-SMC resample at 512k particles). Samplers use this
analysis to skip ensemble-invariant leaves in ``resample_tree``
(``invariant=`` argument).

Soundness: the analysis is conservative (false *variants* possible,
false *invariants* not — an untainted output provably does not read
the key). Samplers that reuse a build-time mask across edit steps rely
on one extra invariant: edits must not write key-dependent data into a
leaf that was key-independent at build time. All GFI edit requests
preserve constrained choice *values* (they recompute scores, which are
key-tainted already at build), so this holds for
Update/Regenerate-style rejuvenation.

No reference counterpart (nothing in the reference resamples, SURVEY
§2.2); the interpreter-style jaxpr walk parallels the reference's
forward interpreters (reference ``interpreters/environment.py``).
"""

from __future__ import annotations

from typing import Any

import jax
import jax.extend  # registers jax.extend.core
import jax.tree_util as jtu

__all__ = ["variant_leaf_mask"]

_Literal = jax.extend.core.Literal


def variant_leaf_mask(fn, *args, argnum: int = 0):
    """Per-output-leaf bools: True iff the leaf may depend on
    ``args[argnum]``. Returns a pytree matching ``fn(*args)``'s
    structure (over abstract values — ``fn`` is traced, not run)."""
    flat_args, in_tree = jtu.tree_flatten(args)
    out_store: dict[str, Any] = {}

    def flat_fn(*flat):
        rebuilt = jtu.tree_unflatten(in_tree, flat)
        out = fn(*rebuilt)
        leaves, tree = jtu.tree_flatten(out)
        out_store["tree"] = tree
        return leaves

    closed = jax.make_jaxpr(flat_fn)(*flat_args)
    jaxpr = closed.jaxpr

    # Which flat input positions belong to args[argnum]?
    sizes = [len(jtu.tree_leaves(a)) for a in args]
    start = sum(sizes[:argnum])
    tainted_pos = set(range(start, start + sizes[argnum]))

    tainted: set[int] = {
        id(v) for i, v in enumerate(jaxpr.invars) if i in tainted_pos
    }

    def var_tainted(v) -> bool:
        return not isinstance(v, _Literal) and id(v) in tainted

    for eqn in jaxpr.eqns:
        if any(var_tainted(v) for v in eqn.invars):
            for ov in eqn.outvars:
                tainted.add(id(ov))

    mask = [var_tainted(v) for v in jaxpr.outvars]
    return jtu.tree_unflatten(out_store["tree"], mask)
