"""Warmup adaptation for HMC/NUTS: dual-averaging step size and diagonal
mass matrix, with *cross-chain* reductions — all chains contribute to one
shared (eps, mass) estimate each step, so adaptation information rides the
mesh collectives when the chain axis is sharded (benchmark config 2).

New scope relative to the reference (no NUTS / no adaptation there).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.flatten_util import ravel_pytree

from genjax_xla.gfi.choice_map import ChoiceMap
from genjax_xla.inference.requests.nuts import NUTSInfo, nuts_kernel
from genjax_xla.inference.sp import Target

__all__ = ["DualAveragingState", "warmup_chains", "run_nuts"]


class DualAveragingState(NamedTuple):
    log_eps: jax.Array
    log_eps_avg: jax.Array
    grad_avg: jax.Array
    t: jax.Array
    mu: jax.Array


def da_init(eps0: float) -> DualAveragingState:
    log_eps = jnp.log(jnp.asarray(eps0))
    # log_eps_avg starts at log(eps0): the first update overwrites it
    # fully (t=1 ⇒ w=1), and a ZERO-length warmup then returns eps0
    # instead of exp(0) = 1.0.
    return DualAveragingState(
        log_eps, log_eps, jnp.zeros(()), jnp.zeros(()),
        jnp.log(10.0) + log_eps,
    )


def da_update(state: DualAveragingState, accept_prob: jax.Array,
              target: float = 0.8, gamma: float = 0.05, t0: float = 10.0,
              kappa: float = 0.75) -> DualAveragingState:
    t = state.t + 1.0
    g = target - accept_prob
    grad_avg = (1.0 - 1.0 / (t + t0)) * state.grad_avg + g / (t + t0)
    log_eps = state.mu - jnp.sqrt(t) / gamma * grad_avg
    w = t ** (-kappa)
    log_eps_avg = w * log_eps + (1.0 - w) * state.log_eps_avg
    return DualAveragingState(log_eps, log_eps_avg, grad_avg, t, state.mu)


class WelfordState(NamedTuple):
    mean: jax.Array
    m2: jax.Array
    count: jax.Array


def welford_init(d: int) -> WelfordState:
    return WelfordState(jnp.zeros(d), jnp.zeros(d), jnp.zeros(()))


def welford_update_moments(state: WelfordState, mean_b: jax.Array,
                           m2_b: jax.Array, n_b) -> WelfordState:
    """Fold pre-reduced batch moments (Chan parallel combine) in."""
    n = state.count
    total = n + n_b
    delta = mean_b - state.mean
    mean = state.mean + delta * n_b / total
    m2 = state.m2 + m2_b + delta**2 * n * n_b / total
    return WelfordState(mean, m2, total)


def welford_update_batch(state: WelfordState, zs: jax.Array) -> WelfordState:
    """Fold a whole (chains, D) batch in — the cross-chain reduction."""
    n_b = zs.shape[0]
    mean_b = jnp.mean(zs, axis=0)
    m2_b = jnp.sum((zs - mean_b) ** 2, axis=0)
    return welford_update_moments(state, mean_b, m2_b, n_b)


def welford_variance(state: WelfordState) -> jax.Array:
    return state.m2 / jnp.maximum(state.count - 1.0, 1.0)


def _cross_chain_stats(zs, accept, mesh, axis_name, block: int = 8):
    """Deterministic cross-chain reductions for one warmup step:
    ``(mean_b, m2_b, accept_mean)`` over the chain axis of ``zs``
    (chains, D) / ``accept`` (chains,).

    All float summation happens in fixed-size units independent of the
    device count: the chain-group size is derived from the GLOBAL chain
    count alone (:func:`~genjax_xla.parallel.collectives._layout_free_block`
    with cap ``block``), so the adapted (eps, mass) trajectory — and
    therefore every downstream sample — is BITWISE identical between the
    vmap path (``mesh=None``) and any power-of-two chain-sharded mesh up
    to 64 devices, for ANY chain count (NUTS amplifies an ulp of eps
    into visibly different chains, so nothing here may depend on
    chains/D; ADVICE r3 + r4 review). A mesh whose axis size the derived
    group cannot divide raises. The mesh variant
    states the communication explicitly: ONE ``shard_map`` whose only
    collectives are all_gathers of O(chains/group) group partials —
    never the (chains, D) positions (HLO-asserted in
    ``tests/parallel/test_sharded_mcmc.py``)."""
    from genjax_xla.parallel.collectives import _layout_free_block

    n_chains = accept.shape[0]
    b = _layout_free_block(n_chains, block)

    def blocked(zs_loc, acc_loc, gather):
        c_loc = acc_loc.shape[0]
        if c_loc % b:
            raise ValueError(
                f"cross-chain adaptation: the layout-independent chain "
                f"group {b} (derived from n_chains={n_chains}) does not "
                f"divide the per-device chain count chains/D={c_loc}. "
                f"Use a power-of-two mesh axis (up to 64 devices)."
            )
        nb = c_loc // b
        z_sums = gather(jnp.sum(
            zs_loc.reshape(nb, b, -1), axis=1
        ))                                       # (nb_global, D)
        a_sums = gather(jnp.sum(
            acc_loc.reshape(nb, b), axis=1
        ))                                       # (nb_global,)
        mean_b = jnp.sum(z_sums, axis=0) / n_chains
        accept_mean = jnp.sum(a_sums) / n_chains
        sq = (zs_loc - mean_b[None, :]) ** 2
        sq_sums = gather(jnp.sum(sq.reshape(nb, b, -1), axis=1))
        m2_b = jnp.sum(sq_sums, axis=0)
        return mean_b, m2_b, accept_mean

    if mesh is None:
        # Same graph structure as the mesh path (a trivial 1-device
        # shard_map): XLA's fusion around a shard_map boundary differs
        # from plain ops at the ulp level, and NUTS amplifies an ulp of
        # eps into visibly different chains — one code path keeps the
        # vmap and every mesh layout bitwise identical.
        import numpy as _np
        from jax.sharding import Mesh as _Mesh

        mesh = _Mesh(_np.asarray(jax.devices()[:1]), (axis_name,))

    from jax.sharding import PartitionSpec as P

    def local(zs_loc, acc_loc):
        def gather(x):
            return lax.all_gather(x, axis_name, axis=0, tiled=True)

        mean_b, m2_b, accept_mean = blocked(zs_loc, acc_loc, gather)
        return mean_b[None], m2_b[None], accept_mean[None]

    mean_b, m2_b, accept_mean = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(axis_name), P(axis_name)),
        out_specs=(P(axis_name), P(axis_name), P(axis_name)),
        check_vma=False,
    )(zs, accept)
    return mean_b[0], m2_b[0], accept_mean[0]


def warmup_chains(
    logdensity_fn: Callable[[jax.Array], jax.Array],
    z0s: jax.Array,
    key: jax.Array,
    num_warmup: int = 500,
    max_depth: int = 8,
    target_accept: float = 0.8,
    eps0: float = 0.1,
    mesh=None,
    axis_name: str = "chains",
    fixed_budget: bool = False,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Adapt (eps, diag inv mass) across chains. ``z0s``: (chains, D).
    Returns ``(z_warm, eps, inv_mass)``. Mass estimation uses the second
    half of warmup; eps adapts every step from the cross-chain mean accept
    probability.

    With ``mesh``, the cross-chain reductions run through the explicit
    deterministic collective path (:func:`_cross_chain_stats`) — bitwise
    identical to the ``mesh=None`` vmap path for any chain-sharded
    layout."""
    n_chains, d = z0s.shape

    def one_step(zs, eps, inv_mass, step_key):
        keys = jax.vmap(
            lambda c: jax.random.fold_in(step_key, c)
        )(jnp.arange(n_chains))
        z_new, infos = jax.vmap(
            lambda z, k: nuts_kernel(
                logdensity_fn, z, k, eps, inv_mass, max_depth,
                fixed_budget=fixed_budget,
            )
        )(zs, keys)
        return z_new, infos.accept_prob

    def body(carry, inp):
        i, step_key = inp
        zs, da, wf, inv_mass = carry
        eps = jnp.exp(da.log_eps)
        z_new, accept_probs = one_step(zs, eps, inv_mass, step_key)
        mean_b, m2_b, accept = _cross_chain_stats(
            z_new, accept_probs, mesh, axis_name
        )
        da = da_update(da, accept, target_accept)
        in_second_half = i >= num_warmup // 2
        wf_new = welford_update_moments(wf, mean_b, m2_b, n_chains)
        wf = jax.tree_util.tree_map(
            lambda a, b: jnp.where(in_second_half, a, b), wf_new, wf
        )
        # Refresh the mass estimate once mid-way through the second half:
        # inv_mass (the position-update preconditioner) ≈ posterior var.
        var = welford_variance(wf)
        use_var = (i == (3 * num_warmup) // 4) & (wf.count > 10)
        inv_mass = jnp.where(use_var, jnp.maximum(var, 1e-6), inv_mass)
        # Restart dual averaging under the new metric (Stan-style
        # windowed adaptation): the step size tuned for the old metric
        # is stale — reset the averages and re-anchor mu at the current
        # log_eps so the remaining quarter re-converges from there.
        da_reset = DualAveragingState(
            da.log_eps, da.log_eps, jnp.zeros(()), jnp.zeros(()),
            jnp.log(10.0) + da.log_eps,
        )
        da = jax.tree_util.tree_map(
            lambda a, b: jnp.where(use_var, a, b), da_reset, da
        )
        return (z_new, da, wf, inv_mass), accept

    keys = jax.random.split(key, num_warmup)
    init = (z0s, da_init(eps0), welford_init(d), jnp.ones(d))
    (zs, da, _wf, inv_mass), _ = lax.scan(
        body, init, (jnp.arange(num_warmup), keys)
    )
    return zs, jnp.exp(da.log_eps_avg), inv_mass


def run_nuts(
    target: Target,
    key: jax.Array,
    n_chains: int = 4,
    num_warmup: int = 500,
    num_samples: int = 1000,
    max_depth: int = 8,
    target_accept: float = 0.8,
    mesh=None,
    axis_name: str = "chains",
    transforms: "dict | str | None" = None,
    fixed_budget: bool = False,
):
    """End-to-end NUTS on a :class:`Target`: initialize chains from the
    prior, warm up (cross-chain adaptation), sample. Returns
    ``(choices_chm_stacked, infos)`` with leading axes (chains, samples)
    on flat sites; for sites under Scan/Vmap combinators the step/lane
    index comes first (``chms["chain", t, "x"]`` → (chains, samples)).

    With ``mesh``, the chain axis is pinned to ``mesh[axis_name]`` — the
    warmup's cross-chain accept/variance reductions become mesh
    collectives, and chains run fully data-parallel across devices.

    ``transforms``: optional dict mapping latent addresses (flat, or
    nested tuple paths) to support bijectors (``"positive"``,
    ``(low, high)``, or a
    :class:`~genjax_xla.inference.transforms.Bijector`) — NUTS then runs
    in unconstrained space with the change-of-variables correction, and
    the returned choice maps are on the constrained (model) scale. Pass
    ``transforms="auto"`` to derive the dict from the distributions'
    support metadata (``infer_transforms``).

    ``fixed_budget``: run every NUTS transition as one unrolled
    fixed-length scan over ``2**max_depth - 1`` masked leapfrog slots
    instead of nested while loops — same transition math with a static
    step count, for schedules that must be shape-static. Slower than
    the while form wherever it was measured (see
    :func:`~genjax_xla.inference.requests.nuts.nuts_kernel`); keep the
    default unless you need the static schedule."""
    constrain = (lambda t: t) if mesh is None else (
        lambda t: _shard_chains(t, mesh, axis_name)
    )
    k_init, k_warm, k_sample = jax.random.split(key, 3)

    from genjax_xla.inference.transforms import (
        constrain_choices,
        resolve_transforms,
        unconstrain_choices,
    )

    transforms = resolve_transforms(target, transforms)

    init_keys = jax.vmap(
        lambda c: jax.random.fold_in(k_init, c)
    )(jnp.arange(n_chains))
    trs, _ = jax.vmap(
        lambda k: target.importance(k, ChoiceMap.empty())
    )(init_keys)
    latents0 = jax.vmap(
        lambda tr: unconstrain_choices(
            target.filter_to_unconstrained(tr.get_choices()), transforms
        )
    )(trs)
    from genjax_xla.gfi.choice_map import partition_values

    # Structural leaves (Switch idx, Mask flags) are deterministic given
    # the target's args, hence chain-independent — close over chain 0's
    # and ravel only the Choice payloads into the position vector.
    vals0, rebuild = partition_values(
        jax.tree_util.tree_map(lambda v: v[0], latents0)
    )
    from genjax_xla.inference.requests.nuts import check_float_latents

    check_float_latents(vals0)
    _, unravel_vals = ravel_pytree(vals0)

    def unravel(z_vec):
        return rebuild(unravel_vals(z_vec))

    z0s = jax.vmap(
        lambda i: ravel_pytree(partition_values(
            jax.tree_util.tree_map(lambda v: v[i], latents0)
        )[0])[0]
    )(jnp.arange(n_chains))
    z0s = constrain(z0s)

    def logdensity(z_vec):
        chm_x, fldj = constrain_choices(unravel(z_vec), transforms)
        tr, w = target.importance(jax.random.key(0), chm_x)
        return tr.get_score() + fldj

    z_warm, eps, inv_mass = warmup_chains(
        logdensity, z0s, k_warm, num_warmup, max_depth, target_accept,
        mesh=mesh, axis_name=axis_name, fixed_budget=fixed_budget,
    )

    def sample_one_chain(z0, chain_key):
        def step(z, step_key):
            z_new, info = nuts_kernel(
                logdensity, z, step_key, eps, inv_mass, max_depth,
                fixed_budget=fixed_budget,
            )
            return z_new, (z_new, info)

        _, (zs, infos) = lax.scan(
            step, z0, jax.random.split(chain_key, num_samples)
        )
        return zs, infos

    chain_keys = jax.vmap(
        lambda c: jax.random.fold_in(k_sample, c)
    )(jnp.arange(n_chains))
    zs, infos = jax.vmap(sample_one_chain)(constrain(z_warm), chain_keys)

    def to_constrained(z):
        chm_x, _ = constrain_choices(unravel(z), transforms)
        return chm_x

    from genjax_xla.gfi.choice_map import lanes_leading

    # vmap stacked (chains, samples) axes in front of every leaf; put
    # Indexed (Scan/Vmap site) lane axes back in front so address
    # indexing works — batch dims trail on those values.
    chms = lanes_leading(
        jax.vmap(jax.vmap(to_constrained))(constrain(zs)), 2
    )
    return chms, infos


def _shard_chains(tree, mesh, axis_name):
    from genjax_xla.parallel.mesh import shard_leading_axis

    return shard_leading_axis(tree, mesh, axis_name)
