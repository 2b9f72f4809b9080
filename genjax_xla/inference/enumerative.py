"""Exact enumerative posteriors for finite discrete models.

For a :class:`Target` whose every unconstrained site is a scalar
finite-support distribution (``flip`` / ``bernoulli`` / ``categorical``),
the posterior is computable exactly: assess the model on the full product
grid of support combinations and normalize. Formulation: the
grid is ONE vmapped ``assess`` over K = ∏ |support_i| combinations — a
single XLA program, no Python loop over states — so ~10^5-state grids
are a few milliseconds on an accelerator.

This generalizes the DiscreteHMM-specific exact testbed
(``inference/exact_testbed.py``) to arbitrary discrete ``@gen`` models:
the primary use is as an ORACLE for testing approximate algorithms
(MH/SMC/VI on mixture assignments, switch indices, boolean graphs), the
same role enumeration plays in the reference's test strategy
(SURVEY §4's exact-inference testbed row). New scope relative to the
reference (no general enumerator there; Gen.jl has
``enumerative_inference`` — re-derived here, not translated).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp

from genjax_xla.gfi.choice_map import ChoiceMap
from genjax_xla.inference.sp import Target

__all__ = ["EnumerationResult", "enumerate_posterior"]

#: distribution name -> (args -> 1-D support array). Only SCALAR sites
#: enumerate (a vector flip would exponentiate the grid silently).
_FINITE_SUPPORTS: dict[str, Callable[[tuple], jax.Array]] = {
    "flip": lambda args: jnp.array([False, True]),
    "bernoulli": lambda args: jnp.array([False, True]),
    "categorical": lambda args: jnp.arange(jnp.shape(args[0])[-1]),
}


class EnumerationResult(NamedTuple):
    """Exact posterior over the discrete latent grid.

    ``paths``: tuple of address paths (tuples), one per enumerated site.
    ``values``: per-site (K,) arrays — row k is one support combination.
    ``log_probs``: (K,) normalized posterior log-probabilities.
    ``log_marginal``: exact log evidence log p(constraints).
    """

    paths: tuple
    values: tuple
    log_probs: jax.Array
    log_marginal: jax.Array

    def site_marginal(self, *path) -> tuple[jax.Array, jax.Array]:
        """``(support, probs)``: the exact marginal of one site."""
        i = self.paths.index(tuple(path))
        vals = self.values[i]
        support = jnp.unique(vals)
        p = jnp.exp(self.log_probs)
        probs = jax.vmap(
            lambda s: jnp.sum(jnp.where(vals == s, p, 0.0))
        )(support)
        return support, probs

    def map_assignment(self) -> dict:
        """The exact MAP combination, as ``{path: value}``."""
        k = int(jnp.argmax(self.log_probs))
        return {p: v[k] for p, v in zip(self.paths, self.values)}


def _discrete_sites(tr, constrained, path=()):
    """Walk a trace, yielding ``(path, support)`` for every unconstrained
    scalar finite-support distribution site; raise on anything the exact
    grid cannot represent."""
    from genjax_xla.lang.distributions.distribution import DistributionTrace
    from genjax_xla.lang.static import StaticTrace

    if isinstance(tr, DistributionTrace):
        if constrained(path):
            return
        name = getattr(tr.gen_fn, "name", None)
        fn = _FINITE_SUPPORTS.get(name)
        if fn is None:
            raise ValueError(
                f"enumerate_posterior: site {path} is a '{name}' "
                "distribution — not finite-support-enumerable. Exact "
                "enumeration needs every latent to be a scalar "
                f"flip/bernoulli/categorical; constrain or marginalize "
                f"{path} instead."
            )
        if jnp.ndim(tr.value) != 0:
            raise ValueError(
                f"enumerate_posterior: site {path} is vector-valued "
                f"(shape {jnp.shape(tr.value)}); only scalar discrete "
                "sites enumerate (a vector site would exponentiate the "
                "grid). Rewrite it as scalar sites under distinct "
                "addresses."
            )
        yield path, fn(tr.args)
        return
    if isinstance(tr, StaticTrace):
        for addr, sub in zip(tr.addresses, tr.subtraces):
            yield from _discrete_sites(sub, constrained, path + (addr,))
        return
    raise ValueError(
        f"enumerate_posterior: unsupported trace node "
        f"{type(tr).__name__} at {path} — enumeration walks plain "
        "@gen nesting; unroll combinators or enumerate by hand."
    )


def enumerate_posterior(
    target: Target,
    max_states: int = 100_000,
) -> EnumerationResult:
    """Exact posterior + evidence of a finite discrete :class:`Target`.

    Probes the model once to discover the unconstrained discrete sites,
    builds the full support product grid (guarded by ``max_states``),
    and evaluates ``assess`` on every combination in one vmap. Returns
    an :class:`EnumerationResult` (use ``site_marginal`` /
    ``map_assignment`` / ``log_marginal``)."""
    from genjax_xla.inference.transforms import path_present

    probe_tr, _ = target.importance(jax.random.key(0), ChoiceMap.empty())
    latents = target.filter_to_unconstrained(probe_tr.get_choices())

    def constrained(path):
        # A path absent from the latent choices is observed.
        return not path_present(latents, path)

    sites = list(_discrete_sites(probe_tr, constrained))
    if not sites:
        raise ValueError(
            "enumerate_posterior: no unconstrained discrete sites found."
        )
    paths = tuple(p for p, _ in sites)
    supports = [s for _, s in sites]

    k_total = 1
    for s in supports:
        k_total *= int(s.shape[0])
    if k_total > max_states:
        raise ValueError(
            f"enumerate_posterior: {k_total} support combinations "
            f"exceed max_states={max_states}; raise the cap explicitly "
            "if the grid is intended."
        )

    # Product grid: per-site (K,) value arrays via index arithmetic.
    idx = jnp.arange(k_total)
    values = []
    stride = k_total
    for s in supports:
        n = s.shape[0]
        stride //= n
        values.append(s[(idx // stride) % n])
    values = tuple(values)

    def logp(*vals):
        chm = target.constraint
        for path, v in zip(paths, vals):
            chm = chm | ChoiceMap.entry(v, *path)
        score, _ = target.p.assess(chm, target.args)
        return score

    lps = jax.vmap(logp)(*values)
    log_z = jax.scipy.special.logsumexp(lps)
    return EnumerationResult(paths, values, lps - log_z, log_z)
