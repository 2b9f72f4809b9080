"""Sequence parallelism: TIME-axis-sharded forward filtering for discrete
state-space models over a device mesh.

The reference handles long sequences with an on-device ``lax.scan``
(``/root/reference/src/genjax/_src/generative_functions/combinators/
scan.py:221-226``) and its HMM posterior with two sequential scans
(``.../distributions/custom/discrete_hmm.py:141-192``) — one device, O(T)
depth. ``genjax_xla`` already parallelizes the TIME dimension on one device
(``lang/distributions/discrete_hmm.forward_filter_parallel``: associative
scan over log-space step matrices). This module extends that to a MESH:
the sequence is sharded over devices (SURVEY §2.3's sequence-parallel
row across devices), with communication that is O(T/block · S²) block
summaries — never the per-step (T, S) filter states.

Algorithm (deterministic blocked composition — the same fixed-block-tree
trick as ``parallel/collectives.py``):

1. Uniformize the chain as T log-space step matrices: ``M_0 =
   log-diag(prior + obs_0)`` and ``M_t = transition_logits +
   obs_ll[t][None, :]`` for t ≥ 1, so that ``alpha_t = 0_S ∘ M_0 ∘ … ∘
   M_t`` (log-space vector·matrix chain).
2. Each device folds its local matrices into per-block products
   (``block`` matrices per block, strictly inside one shard), via
   sequential log-matmuls in time order.
3. ONE ``all_gather`` of the (T/block, S, S) block summaries; every
   device then folds the summaries sequentially (replicated, identical
   op order) into inclusive prefixes and reads off its own blocks'
   incoming prefixes ``G_k = M-product before block k``.
4. Per-step states: within each block, the (S,) state vector starts at
   ``0_S ∘ G_k`` and advances with the same ``logsumexp(v[:,None] +
   trans) + obs`` recursion the sequential filter uses.

Because every float reduction happens in fixed-size units whose
boundaries depend only on (T, block) — never on the device count — the
result is BITWISE identical across 1/2/4/8-… device meshes. The default
``block=None`` derives the block from T alone
(``collectives._layout_free_block``), valid for every power-of-two mesh;
an explicit ``block`` is honored strictly — it must divide T/D for the
layout in use (non-dividing OR oversize blocks raise; clamping would
silently make the association device-count-dependent — r4 review).
With ``D=1, block=T`` the computation degenerates to the sequential
recursion and is bitwise equal to ``forward_filter``.

Cost model (the standard parallel-in-time tradeoff, same as
``forward_filter_parallel``): the block-summary pass costs S× the
sequential filter's per-step work (S³ log-matmul vs S² vector update) —
but it is matrix-unit work and the time axis splits D ways, so wall time
wins for D ≳ S / (matrix-unit advantage). Communication per device per filter: one
all_gather of (T/block)·S² floats + nothing else.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
from jax.scipy.special import logsumexp
from jax.sharding import Mesh, PartitionSpec as P

__all__ = ["time_sharded_filter", "time_sharded_backward_sample"]


def _check_block(T: int, n_dev: int, block: int | None) -> int:
    local_T = T // n_dev
    if T % n_dev:
        raise ValueError(
            f"time_sharded_filter: sequence length T={T} must be a "
            f"multiple of the mesh axis size D={n_dev}."
        )
    if block is None:
        # Layout-free default: derived from T and the cap only, so the
        # block boundaries — and the float associations they fix — are
        # identical under every power-of-two layout (the collectives
        # contract; an explicit block is honored strictly instead).
        from genjax_xla.parallel.collectives import _layout_free_block

        block = _layout_free_block(T, 256)
    if local_T % block:
        # Includes block > T/D: clamping would silently make the
        # effective block (hence the summation association) a function
        # of the device count — exactly the hazard this module's
        # bitwise contract exists to rule out (r4 review).
        raise ValueError(
            f"time_sharded_filter: block={block} must divide the "
            f"per-device step count T/D={local_T} (bitwise "
            f"layout-independence contract; see parallel/collectives). "
            f"Pass block=None to derive a layout-free block from T."
        )
    return block


def _log_matmul(A: jax.Array, B: jax.Array) -> jax.Array:
    # (S,S)·(S,S) in the (logsumexp, +) semiring; kept inline (jnp) so
    # the fold stays one fused XLA op chain under vmap/scan. The Pallas
    # kernel in ops/logmatmul is a drop-in for larger S.
    return logsumexp(A[:, :, None] + B[None, :, :], axis=1)


def time_sharded_filter(
    config,
    observations: jax.Array,
    mesh: Mesh,
    axis_name: str = "time",
    block: int | None = None,
) -> tuple[jax.Array, jax.Array]:
    """Forward filtering with the TIME axis sharded over ``mesh``.

    Returns ``(alphas, log_marginal)`` exactly like
    ``discrete_hmm.forward_filter``: ``alphas[t, s] = log P(z_t = s,
    x_{1:t})`` (sharded ``P(axis_name)`` on the step axis) and the data
    log-marginal (replicated). ``config`` is a
    :class:`~genjax_xla.lang.distributions.discrete_hmm.DiscreteHMMConfiguration`.

    Bitwise layout-independent across mesh sizes (default
    ``block=None`` derives a layout-free block from T; an explicit
    block must divide T/D); bitwise equal to the sequential
    ``forward_filter`` at ``D=1, block=T``."""
    T = observations.shape[0]
    S = config.num_states
    n_dev = mesh.shape[axis_name]
    b = _check_block(T, n_dev, block)
    local_T = T // n_dev
    nb_local = local_T // b
    nb_global = T // b

    obs_ll = config.observation_logits[:, observations].T    # (T, S)
    trans = config.transition_logits
    alpha0 = config.prior_logits + obs_ll[0]
    neg_inf = jnp.finfo(obs_ll.dtype).min

    def step_matrix(t: int, obs_row: jax.Array) -> jax.Array:
        """M_t (S, S): log-diag(alpha0) at t=0, trans + obs_t after."""
        diag0 = jnp.where(
            jnp.eye(S, dtype=bool), alpha0[None, :], neg_inf
        )
        return jnp.where(t == 0, diag0, trans + obs_row[None, :])

    def local(obs_loc):
        d = lax.axis_index(axis_name)
        t_base = d * local_T

        # ---- pass 1: per-block summary products (sequential, in time
        # order, strictly within the block) --------------------------------
        def block_summary(j):
            t0 = t_base + j * b

            def fold(P_acc, i):
                M = step_matrix(t0 + i, obs_loc[j * b + i])
                return _log_matmul(P_acc, M), None

            P0 = step_matrix(t0, obs_loc[j * b])
            P_blk, _ = lax.scan(fold, P0, jnp.arange(1, b))
            return P_blk

        summaries = jax.vmap(block_summary)(jnp.arange(nb_local))

        # ---- one all_gather of (nb_global, S, S) block summaries ---------
        all_sums = lax.all_gather(
            summaries, axis_name, axis=0, tiled=True
        )

        # ---- replicated global fold: inclusive prefixes, identical op
        # order on every device ---------------------------------------------
        def gfold(G, Sk):
            Gn = _log_matmul(G, Sk)
            return Gn, Gn

        _, inc = lax.scan(gfold, all_sums[0], all_sums[1:])
        inclusive = jnp.concatenate([all_sums[:1], inc], axis=0)

        # ---- pass 2: per-step states from each block's incoming prefix ---
        zeros_v = jnp.zeros((S,), obs_ll.dtype)

        def block_states(j):
            k = d * nb_local + j
            # v_start = 0_S ∘ (product of blocks < k); block 0 starts
            # from the raw 0_S vector (M_0 is inside the block).
            G_prev = inclusive[jnp.maximum(k - 1, 0)]
            v0 = jnp.where(
                k == 0,
                zeros_v,
                logsumexp(zeros_v[:, None] + G_prev, axis=0),
            )
            t0 = t_base + j * b

            def vstep(v, i):
                t = t0 + i
                obs_row = obs_loc[j * b + i]
                # Same recursion as discrete_hmm.forward_filter, with
                # the t=0 diag handled by the uniform matrix form.
                nxt = jnp.where(
                    t == 0,
                    logsumexp(v[:, None] + step_matrix(0, obs_row),
                              axis=0),
                    logsumexp(v[:, None] + trans, axis=0) + obs_row,
                )
                return nxt, nxt

            _, vs = lax.scan(vstep, v0, jnp.arange(b))
            return vs                                   # (b, S)

        alphas_loc = jax.vmap(block_states)(
            jnp.arange(nb_local)
        ).reshape(local_T, S)

        # ---- log-marginal from the LAST device's final state vector
        # (bitwise-consistent with the per-step pass; psum broadcast) ------
        lz_local = jnp.where(
            d == n_dev - 1, logsumexp(alphas_loc[-1]), 0.0
        )
        log_z = lax.psum(lz_local, axis_name)
        return alphas_loc, log_z

    alphas, log_z = jax.shard_map(
        local, mesh=mesh,
        in_specs=P(axis_name),
        out_specs=(P(axis_name), P()),
    )(obs_ll)
    return alphas, log_z


def time_sharded_backward_sample(
    key: jax.Array,
    config,
    alphas: jax.Array,
    mesh: Mesh,
    axis_name: str = "time",
    block: int | None = None,
) -> jax.Array:
    """Exact posterior path sampling with the TIME axis sharded: the
    backward half of FFBS at mesh scale (sequential reference:
    ``discrete_hmm.backward_sample``; on-device parallel analogue:
    ``backward_sample_parallel``).

    Every step t < T-1 materializes its sampling table ``f_t : z_{t+1}
    ↦ z_t`` (inverse-CDF of ``P(z_t | z_{t+1})`` with one
    ``fold_in(key, t)`` uniform); the final step's table is the constant
    ``z_{T-1}`` draw from ``alphas[-1]``. Tables compose by integer
    gather (``(f ∘ g)[j] = f[g[j]]``) — EXACT, so the blocked structure
    (within-block folds + one all_gather of (T/block, S) int block
    tables + a replicated boundary fold) is bitwise layout-independent
    for ANY block/device split, with no float-association caveat.

    ``alphas`` is the (T, S) output of :func:`time_sharded_filter`
    (sharded ``P(axis_name)``). Returns the sampled path ``z`` (T,)
    int32, sharded the same way. Communication: one all_gather of
    T/block length-S int tables."""
    T, S = alphas.shape
    n_dev = mesh.shape[axis_name]
    b = _check_block(T, n_dev, block)
    local_T = T // n_dev
    nb_local = local_T // b

    trans_T = config.transition_logits.T          # [j, s] = trans[s, j]

    def local(alpha_loc):
        d = lax.axis_index(axis_name)
        t_idx = d * local_T + jnp.arange(local_T)

        us = jax.vmap(
            lambda t: jax.random.uniform(jax.random.fold_in(key, t))
        )(t_idx)

        # Per-step tables: f_t[j] = inverse-CDF draw of z_t | z_{t+1}=j.
        cond = alpha_loc[:, None, :] + trans_T[None, :, :]
        cdf = jnp.cumsum(jax.nn.softmax(cond, axis=-1), axis=-1)
        tab = jnp.argmax(
            cdf >= us[:, None, None], axis=-1
        ).astype(jnp.int32)                        # (local_T, S)
        # Final step: constant table = categorical draw from alphas[-1].
        lcdf = jnp.cumsum(jax.nn.softmax(alpha_loc, axis=-1), axis=-1)
        z_direct = jnp.argmax(
            lcdf >= us[:, None], axis=-1
        ).astype(jnp.int32)                        # (local_T,)
        tab = jnp.where(
            (t_idx == T - 1)[:, None], z_direct[:, None], tab
        )

        # ---- within-block compositions (exact int gathers) ---------------
        def block_table(j):
            def fold(acc, i):
                # acc = f_{t0} ∘ … ∘ f_{t0+i-1}; append f_{t0+i}.
                return acc[tab[j * b + i]], None

            acc0 = tab[j * b]
            acc, _ = lax.scan(fold, acc0, jnp.arange(1, b))
            return acc                              # (S,)

        summaries = jax.vmap(block_table)(jnp.arange(nb_local))
        all_sums = lax.all_gather(
            summaries, axis_name, axis=0, tiled=True
        )                                           # (nb_global, S)

        # ---- replicated boundary fold (right to left): r_k = state
        # entering block k from the right = (S_{k+1} ∘ …)[0] ----------------
        def rfold(r, S_k):
            rn = S_k[r]
            return rn, rn

        # all_gather output is marked varying over the mesh axis; the
        # scalar carry must match.
        r0 = lax.pcast(jnp.int32(0), (axis_name,), to="varying")
        _, rs_rev = lax.scan(rfold, r0, all_sums[::-1][:-1])
        # rs_rev[i] = boundary entering block nb-2-i; last block's is 0.
        boundaries = jnp.concatenate(
            [rs_rev[::-1], jnp.zeros((1,), jnp.int32)]
        )                                           # (nb_global,)

        # ---- per-step backward chase within each local block --------------
        def block_states(j):
            k = d * nb_local + j
            r = boundaries[k]

            def bstep(z, i):
                zn = tab[j * b + i][z]
                return zn, zn

            _, zs_rev = lax.scan(
                bstep, r, jnp.arange(b - 1, -1, -1)
            )
            return zs_rev[::-1]                     # (b,)

        zs_loc = jax.vmap(block_states)(
            jnp.arange(nb_local)
        ).reshape(local_T)
        return zs_loc

    return jax.shard_map(
        local, mesh=mesh, in_specs=P(axis_name), out_specs=P(axis_name)
    )(alphas)
