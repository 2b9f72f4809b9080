"""MAP estimation and Laplace approximation over a :class:`Target`.

New scope relative to the reference (it ships no optimization-based
inference at all — grep of ``/root/reference/src`` finds no optimizer,
MAP, or Hessian use): posterior-mode finding plus a Gaussian
curvature approximation are standard workflow tools (initialize MCMC
at the mode, cheap evidence estimates, amortization targets), and on an
accelerator they are embarrassingly batchable — the whole optimization runs in
one ``lax.scan`` and vmaps over many targets/restarts unchanged.

Design:

- ``map_optimize`` maximizes the joint density of the target's model
  at the constrained observations over the unconstrained latents,
  optionally through the support bijectors of
  ``inference.transforms`` (``transforms="auto"`` derives them from
  distribution support metadata, exactly like ``run_nuts``). The
  optimizer is any optax ``GradientTransformation`` (default
  ``optax.adam``).
- ``laplace_approximation`` expands the (transformed-space,
  Jacobian-included) log density to second order at a given point:
  returns the Gaussian covariance over the flattened unconstrained
  latents and the Laplace evidence estimate
  ``log Ẑ = log p(x*) + d/2·log 2π − ½·log|H|``. Exact for conjugate
  Gaussian targets (tested).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
from jax import lax
from jax.flatten_util import ravel_pytree

from genjax_xla.core.pytree import Const
from genjax_xla.gfi.choice_map import ChoiceMap
from genjax_xla.inference.requests.hmc import _grad_unzip, _grad_zip
from genjax_xla.inference.sp import Target
from genjax_xla.inference.transforms import (
    constrain_choices,
    infer_transforms,
    unconstrain_choices,
)

__all__ = ["MAPResult", "LaplaceResult", "map_optimize",
           "laplace_approximation"]


class MAPResult(NamedTuple):
    choices: ChoiceMap      # latents at the optimum (constrained space)
    score: jax.Array        # joint log density at (choices | constraint)
    losses: jax.Array       # per-step objective trajectory (n_steps,)
    transforms: Const       # resolved transforms dict, as a static Const
                            # (jit-returnable; pass ``res.transforms``
                            # straight to laplace_approximation)


class LaplaceResult(NamedTuple):
    mean: ChoiceMap         # expansion point, constrained space
    mean_flat: jax.Array    # flattened unconstrained coordinates (d,)
    cov: jax.Array          # (d, d) covariance in unconstrained coords
    log_z: jax.Array        # Laplace evidence estimate
    unravel: Callable[[jax.Array], Any]  # flat -> unconstrained pytree


def _resolve_transforms(target: Target, trace, transforms):
    if isinstance(transforms, Const):
        transforms = transforms.value
    if transforms == "auto":
        from genjax_xla.inference.transforms import _addr_path, _map_at

        latents = target.filter_to_unconstrained(trace.get_choices())

        def _observed(addr):
            # Same Indexed-transparent liveness probe as
            # adaptation.warmup_chains: excluded = not in the latents.
            _, found = _map_at(
                latents, _addr_path(addr), lambda v, gate, branch: v
            )
            return not found

        return infer_transforms(trace, exclude=_observed)
    if isinstance(transforms, str):
        raise ValueError(
            f"transforms={transforms!r}: expected a dict, None, or the "
            'string "auto".'
        )
    return dict(transforms) if transforms else {}


def _split_latents(target: Target, trace, transforms):
    """(differentiable unconstrained latents, rezip closure)."""
    latents = target.filter_to_unconstrained(trace.get_choices())
    u_chm = (
        unconstrain_choices(latents, transforms)
        if transforms else latents
    )
    grad_tree, nongrad_tree = _grad_unzip(u_chm)

    def logpost(grad_tree):
        u = _grad_zip(grad_tree, nongrad_tree)
        if transforms:
            x, fldj = constrain_choices(u, transforms)
        else:
            x, fldj = u, jnp.zeros(())
        score, _ = target.p.assess(x | target.constraint, target.args)
        return score, fldj

    return grad_tree, nongrad_tree, logpost


def _to_constrained(grad_tree, nongrad_tree, transforms) -> ChoiceMap:
    u = _grad_zip(grad_tree, nongrad_tree)
    if transforms:
        x, _ = constrain_choices(u, transforms)
        return x
    return u


def map_optimize(key: jax.Array, target: Target, *,
                 n_steps: int = 500, optimizer=None,
                 transforms=None, include_jacobian: bool = False,
                 init: ChoiceMap | None = None) -> MAPResult:
    """Gradient-ascent MAP of ``target``'s latents.

    ``init``: optional constrained-space latent choice map to start
    from (otherwise latents are sampled via ``target.importance``).
    ``include_jacobian=True`` maximizes the *transformed-space* density
    (score + forward log-det-Jacobian) — the right expansion point for
    :func:`laplace_approximation`; the default maximizes the plain
    joint density, i.e. the constrained-space MAP."""
    import optax

    if optimizer is None:
        optimizer = optax.adam(1e-2)
    tr, _ = target.importance(
        key, init if init is not None else ChoiceMap.empty()
    )
    tf = _resolve_transforms(target, tr, transforms)
    grad_tree, nongrad_tree, logpost = _split_latents(target, tr, tf)

    def loss_fn(g):
        score, fldj = logpost(g)
        return -(score + (fldj if include_jacobian else 0.0))

    opt_state = optimizer.init(grad_tree)

    def step(carry, _):
        g, opt_state = carry
        loss, grads = jax.value_and_grad(loss_fn)(g)
        updates, opt_state = optimizer.update(grads, opt_state, g)
        g = optax.apply_updates(g, updates)
        return (g, opt_state), loss

    (g_final, _), losses = lax.scan(
        step, (grad_tree, opt_state), None, length=n_steps
    )
    x_chm = _to_constrained(g_final, nongrad_tree, tf)
    score, _ = target.p.assess(x_chm | target.constraint, target.args)
    return MAPResult(x_chm, score, losses, Const(tf))


def laplace_approximation(target: Target, latents: ChoiceMap, *,
                          transforms=None,
                          key: jax.Array | None = None) -> LaplaceResult:
    """Second-order expansion of the transformed-space log density at
    ``latents`` (constrained-space latent choice map, e.g.
    ``map_optimize(..., include_jacobian=True).choices``).

    ``latents`` must cover every unconstrained address of the target: the
    expansion point must be fully determined by the caller, not by hidden
    draws. Sites not covered would be silently sampled; that is rejected
    unless an explicit ``key`` is passed (in which case the caller owns
    the randomness of the fill-in draws)."""
    # Build a trace-free split: reuse the target's model via a scored
    # generate at the given latents (weights unused).
    gen_key = jax.random.key(0) if key is None else key
    tr, _ = target.importance(gen_key, latents)
    if key is None:
        # Every unconstrained choice in the trace must have come from
        # `latents` — any leaf surviving the complement filter was sampled.
        uncon = target.filter_to_unconstrained(tr.get_choices())
        hidden = uncon.filter(~latents.get_selection())
        if not hidden.static_is_empty():
            raise ValueError(
                "laplace_approximation: `latents` does not cover all "
                "unconstrained addresses of the target; the uncovered "
                "sites would be silently sampled with a fixed key. Pass "
                "a full latent choice map, or an explicit `key` to own "
                "the fill-in draws."
            )
    tf = _resolve_transforms(target, tr, transforms)
    grad_tree, nongrad_tree, logpost = _split_latents(target, tr, tf)
    flat, unravel = ravel_pytree(grad_tree)
    d = flat.shape[0]

    def logdens(flat_):
        score, fldj = logpost(unravel(flat_))
        return score + fldj

    h = -jax.hessian(logdens)(flat)                    # (d, d)
    sign, logdet = jnp.linalg.slogdet(h)
    cov = jnp.linalg.inv(h)
    log_z = (
        logdens(flat) + 0.5 * d * jnp.log(2.0 * jnp.pi) - 0.5 * logdet
    )
    # A non-PD Hessian means the point is not a mode: poison log_z.
    log_z = jnp.where(sign > 0, log_z, jnp.nan)
    x_chm = _to_constrained(grad_tree, nongrad_tree, tf)
    return LaplaceResult(x_chm, flat, cov, log_z, unravel)
