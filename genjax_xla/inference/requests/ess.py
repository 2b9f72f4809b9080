"""Elliptical slice sampling (Murray, Adams & MacKay 2010) as an edit
request: a tuning-free transition for latents with (conditionally)
Gaussian priors — the workhorse move for GP-style models where HMC's step
size is awkward to adapt.

GFI-native decomposition: for the selected addresses the posterior factors
as ``p(z | rest) ∝ N(z; m, Σ) · L(z)`` with

- the prior term read off the trace itself — ``trace.project(selection)``
  is exactly the selected sites' log-density given everything else
  (``gfn.py:90``), so the log-likelihood is
  ``total score − project(selection)`` with no user-supplied density;
- the ellipse's auxiliary draw ``nu ~ N(m, Σ)`` obtained by ``generate``
  with only the complement constrained — a fresh prior draw of the
  selected sites under the model itself.

The slice-shrinkage loop is one ``lax.while_loop`` (expected ~1.4
likelihood evaluations per transition); everything jits/vmaps, so many
chains run in one XLA program like the other kernels in this package.

``prior_mean``: the ellipse rotates about the prior mean — pass it when
the selected sites' Gaussian prior is not centered at zero (a scalar or
an array matching the raveled position). The transition is exact for any
correct mean; a wrong mean silently changes the stationary distribution,
hence the explicit argument rather than a guess.

New scope relative to the reference (no slice samplers there; its only
MCMC building blocks are HMC and Rejuvenate — SURVEY §2.2).
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
from jax import lax
from jax.flatten_util import ravel_pytree

from genjax_xla.core.pytree import Pytree
from genjax_xla.core.compiler.interpreters.incremental import Diff
from genjax_xla.gfi.choice_map import partition_values
from genjax_xla.gfi.concepts import Argdiffs, EditRequest
from genjax_xla.gfi.gfn import Trace
from genjax_xla.gfi.requests import Update
from genjax_xla.gfi.selection import Selection

__all__ = ["EllipticalSlice", "elliptical_slice_kernel"]


def elliptical_slice_kernel(
    loglik_fn,
    z: jax.Array,
    nu: jax.Array,
    key: jax.Array,
    mean: jax.Array | float = 0.0,
    max_iters: int = 64,
):
    """One ESS transition on the raveled position ``z`` with auxiliary
    prior draw ``nu``. Returns ``(z_new, n_lik_evals)``.

    ``loglik_fn`` is the NON-Gaussian factor only (prior excluded);
    ``max_iters`` bounds the shrinkage loop (the acceptance set always
    contains a neighborhood of θ=0, so the bracket shrinking toward 0
    terminates in ~1–3 iterations in practice — the bound is a jit-safe
    backstop, with the current point returned if it is ever hit)."""
    k_u, k_theta, k_loop = jax.random.split(key, 3)
    ll0 = loglik_fn(z)
    log_u = ll0 + jnp.log(jax.random.uniform(k_u, ()))
    theta0 = jax.random.uniform(k_theta, (), minval=0.0,
                                maxval=2.0 * jnp.pi)
    zc = z - mean
    nuc = nu - mean

    def proposal(theta):
        return mean + zc * jnp.cos(theta) + nuc * jnp.sin(theta)

    def cond(c):
        _key, _tmin, _tmax, _theta, _zp, accepted, i = c
        return ~accepted & (i < max_iters)

    def body(c):
        key, tmin, tmax, theta, _zp, _accepted, i = c
        zp = proposal(theta)
        accepted = loglik_fn(zp) > log_u
        # Shrink the bracket toward 0 on rejection and redraw.
        tmin = jnp.where(theta < 0.0, theta, tmin)
        tmax = jnp.where(theta >= 0.0, theta, tmax)
        key, k_next = jax.random.split(key)
        theta_next = jax.random.uniform(
            k_next, (), minval=tmin, maxval=tmax
        )
        theta = jnp.where(accepted, theta, theta_next)
        return (key, tmin, tmax, theta, zp, accepted, i + 1)

    init = (
        k_loop, theta0 - 2.0 * jnp.pi, theta0, theta0, z,
        jnp.asarray(False), jnp.zeros((), jnp.int32),
    )
    _key, _tmin, _tmax, _theta, zp, accepted, iters = lax.while_loop(
        cond, body, init
    )
    # Backstop: an exhausted bracket keeps the current point (exact —
    # staying put is always a valid slice-sampling outcome at θ=0).
    z_new = jnp.where(accepted, zp, z)
    return z_new, iters + 1  # +1 for the initial loglik(z) evaluation


#: Distributions whose prior an ellipse is exact for. ESS on anything
#: else silently samples a wrong stationary distribution, so the edit
#: probes the trace and raises (ADVICE r4: no runtime signal before).
_GAUSSIAN_SITES = frozenset({"normal", "mv_normal_diag", "mv_normal"})


def _check_gaussian_sites(tr, sel, path=()):
    """Walk a trace at probe time, raising if any statically-selected
    distribution site is non-Gaussian. Best effort: combinator trace
    nodes and dynamic selection flags are skipped (the docstring
    contract still applies there); plain ``@gen`` nesting — the common
    ESS use — is fully validated."""
    from genjax_xla.lang.distributions.distribution import DistributionTrace
    from genjax_xla.lang.static import StaticTrace

    if isinstance(tr, DistributionTrace):
        flag = sel.check()
        if not isinstance(flag, (bool, int)) or not flag:
            return  # dynamic flag or unselected: nothing to prove
        name = getattr(tr.gen_fn, "name", None)
        if name not in _GAUSSIAN_SITES:
            raise ValueError(
                f"EllipticalSlice: selected site {path} is a '{name}' "
                "distribution — the elliptical slice transition is only "
                "valid for (conditionally) Gaussian priors "
                f"({', '.join(sorted(_GAUSSIAN_SITES))}). Select only "
                "Gaussian sites, use Regenerate/HMC for this one, or — "
                "if the site IS a custom Gaussian density the name "
                "check cannot recognize — pass "
                "EllipticalSlice(..., check_gaussian=False)."
            )
        return
    if isinstance(tr, StaticTrace):
        for addr, sub in zip(tr.addresses, tr.subtraces):
            _check_gaussian_sites(sub, sel(addr), path + (addr,))


@Pytree.dataclass
class EllipticalSlice(EditRequest):
    """ESS over the selected choices of a trace. The selected sites'
    prior (given everything unselected) must be Gaussian — normal /
    mv_normal_diag / mv_normal sites whose parameters depend only on
    unselected choices (enforced at probe time by
    :func:`_check_gaussian_sites` for plain ``@gen`` nesting). The
    returned edit weight is 0 (ESS leaves the posterior invariant;
    under ``mh`` it always accepts).

    ``check_gaussian=False`` skips the probe-time site check — the
    escape hatch for CUSTOM Gaussian densities (``exact_density``
    wrappers the name whitelist cannot recognize); the Gaussian-prior
    contract itself still applies."""

    selection: Selection
    prior_mean: Any = 0.0
    max_iters: int = Pytree.static(default=64)
    check_gaussian: bool = Pytree.static(default=True)

    def edit(self, key: jax.Array, tr: Trace[Any], argdiffs: Argdiffs):
        assert Diff.static_check_no_change(argdiffs)
        if self.check_gaussian:
            _check_gaussian_sites(tr, self.selection)
        args = Diff.tree_primal(argdiffs)
        chm = tr.get_choices()
        selected = chm.filter(self.selection)
        complement = chm.filter(~self.selection)
        vals, rebuild = partition_values(selected)
        flat, unravel_vals = ravel_pytree(vals)

        def unravel(z_vec):
            return rebuild(unravel_vals(z_vec))

        gen_fn = tr.get_gen_fn()
        # project's per-site key is only consumed by stochastic-density
        # sites; Gaussian priors are exact, so a fixed key is sound.
        proj_key = jax.random.key(0)

        def loglik(z_vec):
            new_tr, _w = gen_fn.generate(
                proj_key, unravel(z_vec) | complement, args
            )
            prior = new_tr.project(proj_key, self.selection)
            return new_tr.get_score() - prior

        key, nu_key, kern_key, up_key = jax.random.split(key, 4)
        nu_tr, _ = gen_fn.generate(nu_key, complement, args)
        nu_vals, _ = partition_values(
            nu_tr.get_choices().filter(self.selection)
        )
        nu, _ = ravel_pytree(nu_vals)

        mean = self.prior_mean
        if not isinstance(mean, (int, float)):
            # Arrays and pytrees ravel to the position layout; a scalar
            # array becomes shape (1,), which broadcasts identically.
            mean, _ = ravel_pytree(mean)

        z_next, _iters = elliptical_slice_kernel(
            loglik, flat, nu, kern_key, mean, self.max_iters
        )
        new_tr, _w, retdiff, _bwd = Update(unravel(z_next)).edit(
            up_key, tr, argdiffs
        )
        return new_tr, jnp.zeros(()), retdiff, EllipticalSlice(
            self.selection, self.prior_mean, self.max_iters,
            self.check_gaussian,
        )
