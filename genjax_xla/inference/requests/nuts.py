"""No-U-Turn sampler: iterative multinomial NUTS with bounded
tree depth — no recursion, no dynamic shapes; the doubling loop is a
``lax.while_loop``, subtree u-turn checks use the power-of-two checkpoint
trick (Phan, Pradhan & Jankowiak 2019), and everything jits/vmaps so many
chains run in one XLA program and shard over a mesh.

Two execution strategies over the SAME transition math (shared subtree-step
and doubling-merge helpers — identical key streams, identical samples up
to XLA reduction-fusion ulps):

- ``fixed_budget=False`` (default): nested ``lax.while_loop``s that stop as
  soon as the trajectory u-turns. The per-leapfrog body is fully
  vectorized — the u-turn checkpoint writes are one-hot masked selects and
  all ``trailing_ones(i)`` checkpoint checks evaluate as ONE batched
  reduction (no per-checkpoint ``lax.scan`` or per-chain scatter).
- ``fixed_budget=True``: ONE fixed-length ``lax.scan`` over the worst-case
  ``2**max_depth - 1`` leapfrog slots with masked per-chain tree state
  machines, ``unroll``-ed to amortize loop boundaries. It runs every
  slot of the worst-case budget, while real workloads' trees rarely
  approach the 2**max_depth budget (u-turns cap them near the
  posterior's curvature scale), and it measured slower than the while
  strategy on benchmark config 2. Useful only where a static step count
  is required (e.g. ahead-of-time export); prefer the default everywhere
  else.

This is new scope relative to the reference (SURVEY §7: "reference has no
NUTS; build iterative-doubling NUTS with fixed-depth unrolling for XLA").
The selected choices are flattened to one position vector with
``ravel_pytree``; the log-density closes over the complement choices.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

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

__all__ = ["NUTS", "nuts_kernel", "NUTSInfo"]


class _IntegratorState(NamedTuple):
    z: jax.Array
    r: jax.Array
    logp: jax.Array
    grad: jax.Array


class NUTSInfo(NamedTuple):
    accept_prob: jax.Array
    num_steps: jax.Array
    diverging: jax.Array
    energy: jax.Array


class _TrajState(NamedTuple):
    """Whole-trajectory state: left/right frontier, multinomial proposal,
    log-sum of subtree weights, momentum sum, u-turn/divergence flags."""

    key: jax.Array
    left: _IntegratorState
    right: _IntegratorState
    proposal_z: jax.Array
    log_sum_w: jax.Array
    r_sum: jax.Array
    depth: jax.Array
    turning: jax.Array
    diverging: jax.Array
    num_steps: jax.Array
    sum_accept: jax.Array


class _SubState(NamedTuple):
    """Within-subtree state for one doubling's ``2**depth`` leapfrogs."""

    i: jax.Array
    state: _IntegratorState
    proposal_z: jax.Array
    log_sum_w: jax.Array
    r_sum: jax.Array
    r_ckpts: jax.Array
    r_sum_ckpts: jax.Array
    turning: jax.Array
    diverging: jax.Array
    key: jax.Array
    sum_accept: jax.Array


def _leapfrog(logp_and_grad: Callable, eps, inv_mass):
    def step(state: _IntegratorState) -> _IntegratorState:
        r_half = state.r + 0.5 * eps * state.grad
        z_new = state.z + eps * inv_mass * r_half
        logp_new, grad_new = logp_and_grad(z_new)
        r_new = r_half + 0.5 * eps * grad_new
        return _IntegratorState(z_new, r_new, logp_new, grad_new)

    return step


def _kinetic(r, inv_mass):
    return 0.5 * jnp.sum(inv_mass * r * r)


def _is_turning(inv_mass, r_left, r_right, r_sum):
    """Generalized u-turn criterion (Betancourt): check momentum sum
    against both rho ends."""
    v_left = inv_mass * r_left
    v_right = inv_mass * r_right
    rho = r_sum
    turning_left = jnp.dot(v_left, rho - r_left) <= 0.0
    turning_right = jnp.dot(v_right, rho - r_right) <= 0.0
    return turning_left | turning_right


def _fresh_substate(frontier: _IntegratorState, sub_key, max_depth: int,
                    d: int) -> _SubState:
    neg_inf = jnp.asarray(-jnp.inf)
    return _SubState(
        jnp.zeros((), jnp.int32), frontier, frontier.z, neg_inf,
        jnp.zeros_like(frontier.r),
        jnp.zeros((max_depth, d)), jnp.zeros((max_depth, d)),
        jnp.asarray(False), jnp.asarray(False), sub_key, jnp.zeros(()),
    )


def _make_subtree_body(logp_and_grad, eps_signed, inv_mass, energy0,
                       max_delta_energy, max_depth):
    """One leapfrog + subtree bookkeeping step ``_SubState -> _SubState``.

    Shared by the while-loop and fixed-budget kernels — the transition
    math lives here exactly once, so the two strategies are bitwise
    interchangeable given the same key stream."""
    step_fn = _leapfrog(logp_and_grad, eps_signed, inv_mass)

    def body(s: _SubState) -> _SubState:
        state = step_fn(s.state)
        energy = -state.logp + _kinetic(state.r, inv_mass)
        delta = energy - energy0
        diverging = (delta > max_delta_energy) | jnp.isnan(delta)
        delta = jnp.where(jnp.isnan(delta), jnp.inf, delta)
        log_w = -delta
        accept = jnp.minimum(1.0, jnp.exp(-delta))
        # Multinomial progressive sampling within the subtree.
        key, sub_key = jax.random.split(s.key)
        new_log_sum = jnp.logaddexp(s.log_sum_w, log_w)
        take = (
            jnp.log(jax.random.uniform(sub_key, ()))
            < log_w - new_log_sum
        )
        proposal_z = jnp.where(take, state.z, s.proposal_z)
        r_sum = s.r_sum + state.r

        # U-turn checkpointing (Phan et al.): at even i store
        # (r, r_sum) at stack height popcount(i); at odd i check the
        # trailing_ones(i) completed power-of-two subtrees ending here.
        # Both arms are fully vectorized over the max_depth checkpoint
        # slots — a one-hot masked write and a batched u-turn reduction,
        # so the body has no nested loop.
        is_even = (s.i % 2) == 0
        store_idx = _popcount_ones(s.i)  # stack height
        slots = jnp.arange(max_depth)
        write = (is_even & (slots == store_idx))[:, None]
        r_ckpts = jnp.where(write, state.r[None, :], s.r_ckpts)
        r_sum_ckpts = jnp.where(write, r_sum[None, :], s.r_sum_ckpts)

        # Check subtrees: for odd i, the number of completed subtrees
        # equals the number of trailing ones of i — all checked at once.
        n_checks = _trailing_ones(s.i)
        valid = ~is_even & (slots < n_checks)
        ck_idx = jnp.clip(store_idx - slots - 1, 0, max_depth - 1)
        r_l = r_ckpts[ck_idx]                          # (max_depth, D)
        rs = r_sum[None, :] - r_sum_ckpts[ck_idx] + r_l
        v_l = inv_mass[None, :] * r_l
        v_r = inv_mass * state.r
        turn_l = jnp.sum(v_l * (rs - r_l), axis=-1) <= 0.0
        turn_r = (rs - state.r[None, :]) @ v_r <= 0.0
        turning = jnp.any(valid & (turn_l | turn_r))
        return _SubState(
            s.i + 1, state, proposal_z,
            new_log_sum, r_sum, r_ckpts, r_sum_ckpts,
            s.turning | turning, s.diverging | diverging, key,
            s.sum_accept + accept,
        )

    return body


def _merge_doubling(t: _TrajState, sub: _SubState, direction, merge_key,
                    inv_mass, new_key) -> _TrajState:
    """Fold one completed subtree into the trajectory (biased progressive
    sampling between old trajectory and subtree + whole-tree u-turn)."""
    new_frontier = sub.state
    left = jtu_select(direction > 0, t.left, new_frontier)
    right = jtu_select(direction > 0, new_frontier, t.right)

    log_sum_w = jnp.logaddexp(t.log_sum_w, sub.log_sum_w)
    accept_new = (
        jnp.log(jax.random.uniform(merge_key, ()))
        < sub.log_sum_w - t.log_sum_w
    )
    subtree_ok = ~sub.turning & ~sub.diverging
    proposal_z = jnp.where(
        accept_new & subtree_ok, sub.proposal_z, t.proposal_z
    )
    r_sum = t.r_sum + sub.r_sum
    whole_turning = _is_turning(inv_mass, left.r, right.r, r_sum)
    return _TrajState(
        new_key, left, right, proposal_z,
        jnp.where(subtree_ok, log_sum_w, t.log_sum_w),
        r_sum, t.depth + 1,
        sub.turning | whole_turning,
        sub.diverging,
        t.num_steps + sub.i,
        t.sum_accept + sub.sum_accept,
    )


def _run_dynamic(logp_and_grad, traj: _TrajState, eps, inv_mass,
                 max_depth, max_delta_energy, d: int) -> _TrajState:
    """While-loop strategy: trajectory doubling via ``lax.while_loop``;
    within each doubling, 2^j leapfrog steps run in a ``lax.while_loop``
    with u-turn checkpoints at power-of-two boundaries."""
    energy0 = -traj.left.logp + _kinetic(traj.left.r, inv_mass)

    def build_subtree(key, frontier: _IntegratorState, direction,
                      num_steps):
        body = _make_subtree_body(
            logp_and_grad, direction * eps, inv_mass, energy0,
            max_delta_energy, max_depth,
        )

        def cond(s: _SubState):
            return (s.i < num_steps) & ~s.turning & ~s.diverging

        init_sub = _fresh_substate(frontier, key, max_depth, d)
        return lax.while_loop(cond, body, init_sub)

    def cond(t: _TrajState):
        return (t.depth < max_depth) & ~t.turning & ~t.diverging

    def body(t: _TrajState):
        key, dir_key, merge_key, sub_key = jax.random.split(t.key, 4)
        direction = jnp.where(
            jax.random.bernoulli(dir_key), 1.0, -1.0
        )
        frontier = jtu_select(direction > 0, t.right, t.left)
        num_steps = jnp.asarray(2, jnp.int32) ** t.depth
        sub = build_subtree(sub_key, frontier, direction, num_steps)
        return _merge_doubling(t, sub, direction, merge_key, inv_mass, key)

    return lax.while_loop(cond, body, traj)


def _run_fixed(logp_and_grad, traj: _TrajState, eps, inv_mass,
               max_depth, max_delta_energy, d: int,
               unroll: int) -> _TrajState:
    """Fixed-budget strategy: one ``lax.scan`` over the worst-case
    ``2**max_depth - 1`` leapfrog slots. Each slot advances a per-chain
    tree state machine: (a) at a doubling boundary, draw the direction
    and re-seat the subtree at the chosen frontier; (b) take one masked
    leapfrog + subtree-bookkeeping step; (c) when the subtree completes
    (or u-turns/diverges), fold it into the trajectory. Keys advance
    only on ACTIVE slots, so the key stream — and therefore the sampled
    trajectory — is bitwise identical to the while-loop strategy."""
    energy0 = -traj.left.logp + _kinetic(traj.left.r, inv_mass)
    placeholder_sub = _fresh_substate(traj.left, traj.key, max_depth, d)

    class Carry(NamedTuple):
        t: _TrajState
        sub: _SubState
        direction: jax.Array
        merge_key: jax.Array
        done: jax.Array

    def step(c: Carry, _):
        active = ~c.done
        # (a) Doubling boundary: same 4-way split / direction draw /
        # frontier re-seat the while strategy performs per outer
        # iteration — gated so keys only advance on active starts.
        start = active & (c.sub.i == 0)
        key, dir_key, merge_key, sub_key = jax.random.split(c.t.key, 4)
        direction = jnp.where(jax.random.bernoulli(dir_key), 1.0, -1.0)
        frontier = jtu_select(direction > 0, c.t.right, c.t.left)
        fresh = _fresh_substate(frontier, sub_key, max_depth, d)
        sub = jtu_select(start, fresh, c.sub)
        direction = jnp.where(start, direction, c.direction)
        merge_key = jnp.where(start, merge_key, c.merge_key)
        t = c.t._replace(key=jnp.where(start, key, c.t.key))

        # (b) One leapfrog + subtree bookkeeping (the shared body), masked.
        body = _make_subtree_body(
            logp_and_grad, direction * eps, inv_mass, energy0,
            max_delta_energy, max_depth,
        )
        sub = jtu_select(active, body(sub), sub)

        # (c) Subtree completion: the while strategy's inner-loop exit
        # condition, then the same doubling merge.
        num_steps = jnp.asarray(2, jnp.int32) ** t.depth
        sub_done = active & (
            (sub.i >= num_steps) | sub.turning | sub.diverging
        )
        merged = _merge_doubling(t, sub, direction, merge_key, inv_mass,
                                 t.key)
        t = jtu_select(sub_done, merged, t)
        done = c.done | (sub_done & (
            (t.depth >= max_depth) | t.turning | t.diverging
        ))
        # Re-arm the state machine for the next doubling.
        sub = sub._replace(
            i=jnp.where(sub_done, jnp.zeros((), jnp.int32), sub.i)
        )
        return Carry(t, sub, direction, merge_key, done), None

    init = Carry(
        traj, placeholder_sub, jnp.ones(()), traj.key, jnp.asarray(False)
    )
    budget = 2**max_depth - 1
    out, _ = lax.scan(step, init, None, length=budget, unroll=unroll)
    return out.t


def nuts_kernel(
    logdensity_fn: Callable[[jax.Array], jax.Array],
    z0: jax.Array,
    key: jax.Array,
    eps,
    inv_mass: jax.Array | None = None,
    max_depth: int = 10,
    max_delta_energy: float = 1000.0,
    fixed_budget: bool = False,
    unroll: int = 8,
) -> tuple[jax.Array, NUTSInfo]:
    """One NUTS transition from ``z0``. Returns ``(z_next, info)``.

    Iterative multinomial NUTS with bounded depth. ``fixed_budget``
    selects the execution strategy (see module docstring): the default
    while-loop form stops at the u-turn; the fixed-budget form runs one
    ``unroll``-ed ``lax.scan`` over ``2**max_depth - 1`` masked leapfrog
    slots — same transition math and key stream, but a static step count.
    The while form is the faster one (module docstring); reach for
    ``fixed_budget=True`` only when a static schedule is required."""
    D = z0.shape[0]
    if inv_mass is None:
        inv_mass = jnp.ones(D)
    # (D,) shape for the vectorized checkpoint u-turn checks (scalar
    # inv_mass broadcasts exactly — same bits).
    inv_mass = jnp.broadcast_to(jnp.asarray(inv_mass), z0.shape)

    logp_and_grad = jax.value_and_grad(logdensity_fn)

    key, r_key = jax.random.split(key)
    r0 = jax.random.normal(r_key, (D,)) / jnp.sqrt(inv_mass)
    logp0, grad0 = logp_and_grad(z0)
    # Non-finite initial energy (e.g. a zero-density start) would make
    # delta = -inf read as perfect acceptance while the chain never
    # moves. Mark it diverging with accept 0 instead (Stan/numpyro
    # error on this; inside jit we flag it) — the flags are folded in
    # at the end of the transition.
    finite0 = jnp.isfinite(logp0)
    energy0 = -logp0 + _kinetic(r0, inv_mass)
    init = _IntegratorState(z0, r0, logp0, grad0)

    traj = _TrajState(
        key, init, init, z0, jnp.zeros(()), r0,
        jnp.zeros((), jnp.int32), jnp.asarray(False), jnp.asarray(False),
        jnp.zeros((), jnp.int32), jnp.zeros(()),
    )

    if fixed_budget:
        out = _run_fixed(logp_and_grad, traj, eps, inv_mass, max_depth,
                         max_delta_energy, D, unroll)
    else:
        out = _run_dynamic(logp_and_grad, traj, eps, inv_mass, max_depth,
                           max_delta_energy, D)
    accept_prob = out.sum_accept / jnp.maximum(out.num_steps, 1)
    # Fold the non-finite-start flag in: the chain did not move (all
    # deltas were NaN-gated), report accept 0 + diverging so adaptation
    # and diagnostics see the stuck chain instead of accept = 1.
    accept_prob = jnp.where(finite0, accept_prob, 0.0)
    info = NUTSInfo(
        accept_prob, out.num_steps, out.diverging | ~finite0, energy0
    )
    return jnp.where(finite0, out.proposal_z, z0), info


def check_float_latents(vals):
    """Gradient-based kernels require continuous latents: an int leaf
    raveled into the position vector would drift ballistically (its
    gradient through the int-cast is zero) and truncate back to int
    with no MH correction — a silently wrong kernel. Parity with
    HMC's ``static_check_supports_grad`` guard (``hmc.py:36-53``)."""
    import jax.tree_util as _jtu

    for leaf in _jtu.tree_leaves(vals):
        if not jnp.issubdtype(jnp.result_type(leaf), jnp.floating):
            raise TypeError(
                "NUTS position includes a non-float latent (dtype "
                f"{jnp.result_type(leaf)}). Exclude discrete sites "
                "from the selection and move them with a separate "
                "Regenerate/enumeration kernel."
            )


def jtu_select(pred, a, b):
    return jax.tree_util.tree_map(
        lambda x, y: jnp.where(pred, x, y), a, b
    )


def _trailing_ones(i):
    """Number of trailing one-bits of i (= number of completed subtrees
    ending at odd position i). Single-op form: ``i ^ (i+1)`` sets the
    trailing-ones run plus the next bit, so popcount − 1 counts the run
    (replaces a per-leapfrog-step scalar while_loop)."""
    i = jnp.asarray(i, jnp.int32)
    return lax.population_count(i ^ (i + 1)) - 1


def _popcount_ones(i):
    """Stack height for checkpoint storage: number of set bits of i
    (one hardware op; replaces a 32-iteration fori_loop per step)."""
    return lax.population_count(jnp.asarray(i, jnp.int32))


@Pytree.dataclass
class NUTS(EditRequest):
    """NUTS over the selected choices of a trace. The returned edit weight
    is 0 (NUTS transitions preserve the posterior; use directly or under
    ``mh`` which then always accepts)."""

    selection: Selection
    eps: Any
    max_depth: int = Pytree.static(default=8)
    inv_mass: Any = None
    fixed_budget: bool = Pytree.static(default=False)

    def edit(self, key: jax.Array, tr: Trace[Any], argdiffs: Argdiffs):
        assert Diff.static_check_no_change(argdiffs)
        args = Diff.tree_primal(argdiffs)
        chm = tr.get_choices()
        selected = chm.filter(self.selection)
        complement = chm.filter(~self.selection)
        # Ravel only the Choice payloads — structural leaves (Switch
        # idx, Mask flags) stay out of the position vector.
        vals, rebuild = partition_values(selected)
        check_float_latents(vals)
        flat, unravel_vals = ravel_pytree(vals)

        def unravel(z_vec):
            return rebuild(unravel_vals(z_vec))

        gen_fn = tr.get_gen_fn()

        def logdensity(z_vec):
            score, _ = gen_fn.assess(unravel(z_vec) | complement, args)
            return score

        key, up_key = jax.random.split(key)
        z_next, info = nuts_kernel(
            logdensity, flat, key, self.eps,
            inv_mass=self.inv_mass, max_depth=self.max_depth,
            fixed_budget=self.fixed_budget,
        )
        new_tr, _w, retdiff, _bwd = Update(unravel(z_next)).edit(
            up_key, tr, argdiffs
        )
        return new_tr, jnp.zeros(()), retdiff, NUTS(
            self.selection, self.eps, self.max_depth, self.inv_mass,
            self.fixed_budget,
        )
