"""Explicit-collective inference reductions: ``shard_map`` implementations
of log-Z̄ / ESS (``psum``) and distributed systematic resampling
(``ppermute`` ring redistribution), living NEXT TO the GSPMD
sharding-constraint path (``parallel/smc.py``).

Why both paths (VERDICT round-1 item 5): the GSPMD path trusts XLA's
sharding propagation to insert collectives — simple, fast, but opaque.
This module states the communication explicitly, so (a) the lowered HLO
can be asserted to contain collectives and NOT a full gather of particle
state (``tests/parallel/test_collectives.py``), and (b) the communication
volume is known by construction:

- log-Z̄ / ESS: one ``psum`` of per-shard partial reductions (2 scalars).
- resampling: one ``all_gather`` of D per-shard weight sums (D scalars —
  never the particle state), then D−1 ``ppermute`` ring steps streaming
  each shard's particle block around the ring. Peak per-device memory is
  O(2·N/D); the full N-particle state is never materialized on one device.

The ring redistribution is EXACT for any offspring imbalance: each output
slot j takes the unique particle whose offspring run [sᵢ, sᵢ+cᵢ) covers
j, found per incoming block by binary search over the block's run starts.
New scope vs the reference (no distributed backend there, SURVEY §2.3).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

__all__ = [
    "shardmap_logz",
    "shardmap_ess",
    "shardmap_systematic_resample",
    "blocked_logz",
    "blocked_ess",
    "blocked_stats",
    "ring_systematic_resample",
    "ring_resample_step",
]


def _local_logsumexp(lw):
    m = jnp.max(lw)
    return m, jnp.sum(jnp.exp(lw - m))


def shardmap_logz(log_weights: jax.Array, mesh: Mesh,
                  axis_name: str = "particles") -> jax.Array:
    """log Z̄ = logsumexp(lw) − log K via explicit psum/pmax."""
    n = log_weights.shape[0]

    def local(lw):
        m_loc, _ = _local_logsumexp(lw)
        m = lax.pmax(m_loc, axis_name)
        s = lax.psum(jnp.sum(jnp.exp(lw - m)), axis_name)
        return (m + jnp.log(s) - jnp.log(n))[None]

    out = jax.shard_map(
        local, mesh=mesh, in_specs=P(axis_name), out_specs=P(axis_name)
    )(log_weights)
    return out[0]


def shardmap_ess(log_weights: jax.Array, mesh: Mesh,
                 axis_name: str = "particles") -> jax.Array:
    """ESS = (Σw)²/Σw² via explicit psum (two shard-local partials)."""

    def local(lw):
        m_loc, _ = _local_logsumexp(lw)
        m = lax.pmax(m_loc, axis_name)
        e = jnp.exp(lw - m)
        s1 = lax.psum(jnp.sum(e), axis_name)
        s2 = lax.psum(jnp.sum(e * e), axis_name)
        return (s1 * s1 / s2)[None]

    out = jax.shard_map(
        local, mesh=mesh, in_specs=P(axis_name), out_specs=P(axis_name)
    )(log_weights)
    return out[0]


def shardmap_systematic_resample(key: jax.Array, log_weights: jax.Array,
                                 tree, mesh: Mesh,
                                 axis_name: str = "particles"):
    """Distributed systematic resampling over the mesh, semantically
    identical to ``inference.smc.resample_tree(..., "systematic")``: the
    same uniform grid ``(j + u0)/N`` inverted against the same weight CDF
    selects the same ancestors; only the float summation order of the CDF
    differs (block-local cumsum + psum'd offsets).
    """
    n = log_weights.shape[0]
    n_dev = mesh.shape[axis_name]
    local_n = n // n_dev

    flat, treedef = jtu.tree_flatten(tree)

    def local(key, lw, *leaves):
        d = lax.axis_index(axis_name)
        # Global normalization: max + sum via collectives (scalars only).
        m = lax.pmax(jnp.max(lw), axis_name)
        e = jnp.exp(lw - m)
        total = lax.psum(jnp.sum(e), axis_name)
        p = e / total
        # Global CDF offset for this shard: exclusive prefix of block
        # sums, from an all_gather of D scalars (NOT particle state).
        block_sum = jnp.sum(p)
        block_sums = lax.all_gather(block_sum, axis_name)  # (D,)
        offset = jnp.cumsum(block_sums)[d] - block_sum
        cum = offset + jnp.cumsum(p)
        # Same u0 on every shard (same key).
        u0 = jax.random.uniform(key, ())
        # Offspring run of local particle i (GLOBAL output indices):
        # [starts_i, ends_i) with ends = ceil(n·F_i − u0) on the global
        # CDF, and the block's first start in closed form from the offset.
        counts_cum = jnp.clip(jnp.ceil(n * cum - u0), 0, n).astype(jnp.int32)
        first = jnp.clip(jnp.ceil(n * offset - u0), 0, n).astype(jnp.int32)
        starts = jnp.concatenate([first[None], counts_cum[:-1]])
        ends = counts_cum

        # My output slots (global indices).
        j_global = d * local_n + jnp.arange(local_n)

        out_leaves = [jnp.zeros((local_n,) + l.shape[1:], l.dtype)
                      for l in leaves]
        filled = jnp.zeros((local_n,), bool)

        # Ring: stream every block through every shard (D steps incl. own).
        def ring_step(step, carry):
            out_leaves, filled, blk_starts, blk_ends, blk_leaves = carry
            # Match my output slots against the current block's runs.
            idx = jnp.clip(
                jnp.searchsorted(blk_starts, j_global, side="right") - 1,
                0, local_n - 1,
            )
            hit = (j_global >= blk_starts[idx]) & (j_global < blk_ends[idx])
            out_leaves = [
                jnp.where(
                    hit.reshape((-1,) + (1,) * (o.ndim - 1)),
                    bl[idx], o,
                )
                for o, bl in zip(out_leaves, blk_leaves)
            ]
            filled = filled | hit
            # Pass the block to the next shard on the ring.
            perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]
            blk_starts = lax.ppermute(blk_starts, axis_name, perm)
            blk_ends = lax.ppermute(blk_ends, axis_name, perm)
            blk_leaves = [lax.ppermute(b, axis_name, perm)
                          for b in blk_leaves]
            return out_leaves, filled, blk_starts, blk_ends, blk_leaves

        carry = (out_leaves, filled, starts, ends, list(leaves))
        for step in range(n_dev):
            carry = ring_step(step, carry)
        out_leaves, filled, *_ = carry
        return tuple(out_leaves)

    specs_in = (P(), P(axis_name)) + tuple(P(axis_name) for _ in flat)
    specs_out = tuple(P(axis_name) for _ in flat)
    out_flat = jax.shard_map(
        local, mesh=mesh, in_specs=specs_in, out_specs=specs_out,
        check_vma=False,
    )(key, log_weights, *flat)
    return jtu.tree_unflatten(treedef, list(out_flat))


# ---------------------------------------------------------------------------
# Deterministic (layout-independent) blocked-CDF product path
# ---------------------------------------------------------------------------
#
# The psum-offset resampler above is semantically correct but its CDF bit
# patterns depend on the device count D (block-local cumsum sizes follow
# N/D), so the SAME program on a 1-device and an 8-device mesh can differ
# at ulp-straddling grid points. The product path below removes that: all
# float summation happens in FIXED-size units chosen independently of D —
#
#   1. within fixed B-lane blocks: one size-B cumsum per block (the
#      association XLA picks is a function of B only);
#   2. across the n/B block sums: all_gather (n/B scalars — O(n/B), never
#      O(n) state) and a replicated size-(n/B) cumsum;
#   3. the monotone repair (cummax) uses max, which is exactly
#      associative, so it is order-independent by construction.
#
# Result: offspring counts, and therefore the resampled ensemble, are
# BITWISE identical across mesh layouts — the contract
# `tests/parallel/test_collectives.py` pins (8- vs 4- vs 1-device
# mesh). The effective B is derived from the GLOBAL n and the cap
# alone (never from n/D), so the float-summation association cannot
# depend on the device count; any power-of-two mesh up to 64 devices
# divides compatibly by construction, and an incompatible layout
# (non-power-of-two factors the derived B does not divide) raises
# instead of silently re-associating (ADVICE r3: a layout-dependent
# block can flip an ESS-gated resample decision).
# Communication per device per resample: one all_gather of 2·(n/B) f32
# block stats + (D−1) ppermute steps of the (n/D)-slot particle block
# (starts/ends int32 + state leaves) — the byte counts in
# docs/comm_model.json. New scope vs the reference (no distributed
# backend there).


def _layout_free_block(n: int, cap: int, reserve_pow2: int = 6) -> int:
    """Effective summation block size derived from the GLOBAL size ``n``
    and the cap ONLY — never from ``n/D`` — so the float-summation
    association is identical in every mesh layout by construction
    (ADVICE r3: anything derived from the per-device count changes the
    association with the device count and silently breaks bitwise
    layout independence).

    The result is the largest divisor of ``n`` that is ≤ ``cap`` and
    whose power-of-two part leaves ``reserve_pow2`` device powers free:
    ``v2(b) ≤ max(0, v2(n) − reserve_pow2)``. It therefore divides
    ``n / 2**k`` for every ``k ≤ min(v2(n), reserve_pow2)`` — any
    power-of-two mesh up to ``2**reserve_pow2`` (64) devices divides
    compatibly, while the block stays as close to the cap as ``n``'s
    factorization allows (it never collapses to per-element partials
    for the tuned power-of-two ensemble sizes)."""
    v = (n & -n).bit_length() - 1  # 2-adic valuation of n
    max_v_b = max(0, v - reserve_pow2)
    for cand in range(min(cap, n), 0, -1):
        if n % cand:
            continue
        v_c = (cand & -cand).bit_length() - 1
        if v_c <= max_v_b:
            return cand
    return 1


def _pick_block(n: int, local_n: int, cap: int) -> int:
    """Resolve the within-shard block size: layout-free derivation from
    the global ``n`` plus a divisibility check against this layout's
    ``local_n`` (fails only for mesh factors the derivation cannot
    serve, e.g. a non-power-of-two axis size the odd part of ``n`` does
    not absorb)."""
    b = _layout_free_block(n, cap)
    if local_n % b:
        raise ValueError(
            f"blocked collectives: the layout-independent block "
            f"{b} (derived from n={n}, cap={cap}) does not divide the "
            f"per-device count n/D={local_n}. Use a power-of-two mesh "
            f"axis (up to 64 devices), or a particle count whose "
            f"factors match the mesh."
        )
    return b


def _blocked_cdf_stats(lw, axis_name, n, n_dev, d, block):
    """Shard-local blocked CDF machinery. Returns
    ``(within, seeds, total_raw, total_rep, sum_sq, m)`` where ``within``
    is the (nb_local, B) within-block raw prefix, ``seeds`` the
    replicated exclusive prefix-max of per-block cum maxima (the global
    cummax seam values), ``total_raw`` the raw Σexp (for logZ/ESS),
    ``total_rep`` the repaired CDF total (for count scaling), ``sum_sq``
    Σexp² (for ESS) and ``m`` the global max log-weight."""
    local_n = lw.shape[0]
    b = _pick_block(n, local_n, block)
    nb_local = local_n // b
    m = lax.pmax(jnp.max(lw), axis_name)
    e = jnp.exp(lw - m)
    eb = e.reshape(nb_local, b)
    within = jnp.cumsum(eb, axis=1)               # fixed-B association
    bsums = within[:, -1]
    bmaxs = jnp.max(within, axis=1)               # max: exactly assoc.
    s2 = jnp.sum(eb * eb, axis=1)                 # fixed-B association
    stats = jnp.stack([bsums, bmaxs, s2])         # (3, nb_local)
    all_stats = lax.all_gather(stats, axis_name, axis=1, tiled=True)
    all_bsums, all_bmaxs, all_s2 = all_stats      # (nb_global,) each
    bcum = jnp.cumsum(all_bsums)                  # fixed n/B association
    bcum_excl = jnp.concatenate([jnp.zeros(1, bcum.dtype), bcum[:-1]])
    total_raw = bcum[-1]
    sum_sq = jnp.sum(all_s2)                      # fixed n/B association
    # Global flattened-cummax seam values: seeds[j] = max raw cum over
    # all elements strictly before block j (max is exact, any order).
    block_cummaxes = bcum_excl + all_bmaxs
    seam = lax.cummax(block_cummaxes)
    seeds = jnp.concatenate([jnp.zeros(1, seam.dtype), seam[:-1]])
    total_rep = seam[-1]
    return within, seeds, bcum_excl, total_raw, total_rep, sum_sq, m


def _blocked_counts(key, within, seeds, bcum_excl, total_rep,
                    n, n_dev, d, local_n):
    """Layout-independent systematic offspring interval [starts, ends)
    per local particle (GLOBAL output indices), exactly the blocked
    analogue of ``inference.smc.systematic_offspring_cumulative``
    (cummax monotone repair + exact-n tail pin)."""
    nb_local, b = within.shape
    my_seeds = lax.dynamic_slice(seeds, (d * nb_local,), (nb_local,))
    my_off = lax.dynamic_slice(bcum_excl, (d * nb_local,), (nb_local,))
    raw = my_off[:, None] + within
    cum = jnp.maximum(lax.cummax(raw, axis=1), my_seeds[:, None])
    u0 = jax.random.uniform(key, ())              # same key ⇒ same u0
    scale = n / total_rep
    ends = jnp.clip(
        jnp.ceil(cum.reshape(local_n) * scale - u0), 0, n
    ).astype(jnp.int32)
    # Exact tail: the globally-last element owns dest n (f32 rounding
    # otherwise drops it for ~25% of seeds at 2^20).
    ends = ends.at[-1].set(
        jnp.where(d == n_dev - 1, n, ends[-1])
    )
    first_cum = my_seeds[0]                       # repaired predecessor
    first = jnp.clip(
        jnp.ceil(first_cum * scale - u0), 0, n
    ).astype(jnp.int32)
    first = jnp.where(d == 0, 0, first)
    starts = jnp.concatenate([first[None], ends[:-1]])
    return starts, ends


def _ring_redistribute(axis_name, n_dev, local_n, d, starts, ends,
                       leaves, init=None):
    """Stream shards' (starts, ends, state) blocks around the ring; each
    output slot takes the unique particle whose offspring run covers it.
    The run lookup is a scatter-mark + cumsum rank count (no per-query
    ``searchsorted``).

    Early exit: the ring runs under ``lax.while_loop`` and stops as soon
    as EVERY device's slots are filled (one psum'd scalar per step).
    Systematic offspring runs are contiguous in global output order, so
    with a balanced resample each shard's slots are covered by its own
    and adjacent blocks — the expected trip count is 2-3 regardless of
    D, cutting per-device comm from O(N) (full ring) to O(N·k/D). The
    result is bitwise identical to the full D-step ring (slots are
    filled by exactly one run; stopping after coverage changes
    nothing).

    ``init`` (optional): ``(out_leaves, filled, all_done)`` seed state
    from the halo fast path — when ``all_done`` is already True the
    while loop executes ZERO trips, so the typical resample moves only
    the 2·H halo slots (see :func:`_halo_exchange`)."""
    base = d * local_n

    if init is None:
        out_leaves = [jnp.zeros((local_n,) + l.shape[1:], l.dtype)
                      for l in leaves]
        filled = jnp.zeros((local_n,), bool)
        done0 = jnp.asarray(False)
    else:
        out_leaves, filled, done0 = init
        out_leaves = list(out_leaves)
    perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]

    def ring_step(carry):
        step, _all_done, out_leaves, filled, blk_starts, blk_ends, \
            blk_leaves = carry
        # idx(t) = #{i : blk_starts[i] ≤ base+t} − 1 via marks+cumsum.
        rel = blk_starts - base
        nbefore = jnp.sum((rel < 0).astype(jnp.int32))
        pos = jnp.where((rel < 0) | (rel >= local_n), local_n, rel)
        marks = jnp.zeros(local_n, jnp.int32).at[pos].add(
            1, mode="drop"
        )
        idx = jnp.clip(
            nbefore + jnp.cumsum(marks) - 1, 0, local_n - 1
        )
        j_global = base + jnp.arange(local_n)
        hit = (j_global >= blk_starts[idx]) & (j_global < blk_ends[idx])
        out_leaves = [
            jnp.where(
                hit.reshape((-1,) + (1,) * (o.ndim - 1)), bl[idx], o
            )
            for o, bl in zip(out_leaves, blk_leaves)
        ]
        filled = filled | hit
        unfilled = lax.psum(
            jnp.sum((~filled).astype(jnp.int32)), axis_name
        )
        all_done = unfilled == 0
        blk_starts = lax.ppermute(blk_starts, axis_name, perm)
        blk_ends = lax.ppermute(blk_ends, axis_name, perm)
        blk_leaves = [lax.ppermute(x, axis_name, perm)
                      for x in blk_leaves]
        return (step + 1, all_done, out_leaves, filled, blk_starts,
                blk_ends, blk_leaves)

    carry = (jnp.int32(0), done0, out_leaves, filled,
             starts, ends, list(leaves))
    if n_dev == 1 and init is None:
        carry = ring_step(carry)
    else:
        carry = lax.while_loop(
            lambda c: (~c[1]) & (c[0] < n_dev),
            ring_step,
            carry,
        )
    return carry[2]


def _mesh_axis_size(mesh: Mesh, axis_name) -> int:
    if isinstance(axis_name, tuple):
        out = 1
        for a in axis_name:
            out *= mesh.shape[a]
        return out
    return mesh.shape[axis_name]


def _match_runs(base, local_n, starts_cat, ends_cat, leaves_cat):
    """Assign output slots [base, base+local_n) from candidate offspring
    runs [starts_cat, ends_cat) (globally sorted). Returns
    ``(out_leaves, filled)``. Scatter-mark + cumsum rank lookup (no
    per-query searchsorted)."""
    m = starts_cat.shape[0]
    rel = starts_cat - base
    nbefore = jnp.sum((rel < 0).astype(jnp.int32))
    pos = jnp.where((rel < 0) | (rel >= local_n), local_n, rel)
    marks = jnp.zeros(local_n, jnp.int32).at[pos].add(1, mode="drop")
    idx = jnp.clip(nbefore + jnp.cumsum(marks) - 1, 0, m - 1)
    j_global = base + jnp.arange(local_n)
    hit = (j_global >= starts_cat[idx]) & (j_global < ends_cat[idx])
    outs = [
        jnp.where(
            hit.reshape((-1,) + (1,) * (x.ndim - 1)),
            x[idx],
            jnp.zeros((local_n,) + x.shape[1:], x.dtype),
        )
        for x in leaves_cat
    ]
    return outs, hit


def _halo_exchange(axis_name, n_dev, H, starts, ends, leaves):
    """Receive the left neighbor's LAST-H and the right neighbor's
    FIRST-H (runs + state): 2·H slots of comm per device instead of
    k·(N/D) full-block ring trips. Returns concatenated candidates in
    global source order."""
    fwd = [(i, (i + 1) % n_dev) for i in range(n_dev)]   # recv from left
    bwd = [(i, (i - 1) % n_dev) for i in range(n_dev)]   # recv from right
    d = lax.axis_index(axis_name)

    def from_left(x):
        y = lax.ppermute(x[-H:], axis_name, fwd)
        # Shard 0 has no left neighbor; neutralize the wrapped slice
        # from shard D-1 (terminal runs [n, n): match nothing).
        return y

    def from_right(x):
        return lax.ppermute(x[:H], axis_name, bwd)

    l_starts, l_ends = from_left(starts), from_left(ends)
    r_starts, r_ends = from_right(starts), from_right(ends)
    # Shard 0 / D-1 have no left/right neighbor; replace the wrapped
    # slices with EMPTY runs at ∓2^30 so candidate starts stay globally
    # nondecreasing (the rank count in _match_runs requires it) while
    # matching nothing.
    neutral_l = d == 0
    neutral_r = d == n_dev - 1
    lo, hi = jnp.int32(-(2**30)), jnp.int32(2**30)
    l_starts = jnp.where(neutral_l, lo, l_starts)
    l_ends = jnp.where(neutral_l, lo, l_ends)
    r_starts = jnp.where(neutral_r, hi, r_starts)
    r_ends = jnp.where(neutral_r, hi, r_ends)
    l_leaves = [from_left(x) for x in leaves]
    r_leaves = [from_right(x) for x in leaves]
    starts_cat = jnp.concatenate([l_starts, starts, r_starts])
    ends_cat = jnp.concatenate([l_ends, ends, r_ends])
    leaves_cat = [
        jnp.concatenate([a, b, c])
        for a, b, c in zip(l_leaves, leaves, r_leaves)
    ]
    return starts_cat, ends_cat, leaves_cat


def ring_resample_step(key: jax.Array, log_weights: jax.Array, tree,
                       mesh: Mesh, axis_name="particles",
                       block: int = 256, halo: int | None = None):
    """The product distributed-resampling step, fused into ONE
    ``shard_map``: deterministic blocked logZ̄/ESS + systematic offspring
    counts + halo-exchange redistribution of the particle state (with
    the ``ppermute`` ring as the exact fallback for pathological
    offspring skew).

    Typical comm per device per resample: 2·``halo`` slots of
    (runs + state) + O(n/block) block stats + a handful of scalars —
    the drift of systematic offspring across a shard boundary is
    O(√N), so a small halo covers balanced resamples and the ring
    executes zero trips. ``halo`` defaults to
    ``min(local_n, max(256, local_n // 16))``; pass 0 to force the
    ring-only path.

    Returns ``(resampled_tree, logz, ess)``. Bitwise layout-independent
    (same result on a 1-, 2-, 4-, 8-… device mesh) unconditionally for
    power-of-two meshes up to 64 devices: the effective summation
    block is derived from the GLOBAL ``n`` and the ``block`` cap only
    (:func:`_layout_free_block`), never from ``n/D`` — the halo/ring
    choice never changes values, only comm volume — and the full
    N-particle state and weight vector are never materialized on one
    device. A mesh whose axis size the derived block cannot divide
    (non-power-of-two factors) raises instead of silently
    re-associating."""
    n = log_weights.shape[0]
    n_dev = _mesh_axis_size(mesh, axis_name)
    local_n = n // n_dev
    if halo is None:
        halo = min(local_n, max(256, local_n // 16))
    flat, treedef = jtu.tree_flatten(tree)

    def local(key, lw, *leaves):
        d = lax.axis_index(axis_name)
        (within, seeds, bcum_excl, total_raw, total_rep, sum_sq,
         m) = _blocked_cdf_stats(lw, axis_name, n, n_dev, d, block)
        logz = m + jnp.log(total_raw) - jnp.log(n)
        ess = total_raw * total_raw / sum_sq
        starts, ends = _blocked_counts(
            key, within, seeds, bcum_excl, total_rep,
            n, n_dev, d, local_n,
        )
        init = None
        if n_dev > 1 and halo > 0:
            s_cat, e_cat, l_cat = _halo_exchange(
                axis_name, n_dev, halo, starts, ends, list(leaves)
            )
            outs, hit = _match_runs(
                d * local_n, local_n, s_cat, e_cat, l_cat
            )
            unfilled = lax.psum(
                jnp.sum((~hit).astype(jnp.int32)), axis_name
            )
            init = (outs, hit, unfilled == 0)
        out = _ring_redistribute(
            axis_name, n_dev, local_n, d, starts, ends, list(leaves),
            init=init,
        )
        return (logz[None], ess[None], *out)

    specs_in = (P(), P(axis_name)) + tuple(P(axis_name) for _ in flat)
    specs_out = (P(axis_name), P(axis_name)) + tuple(
        P(axis_name) for _ in flat
    )
    logz, ess, *out_flat = jax.shard_map(
        local, mesh=mesh, in_specs=specs_in, out_specs=specs_out,
        check_vma=False,
    )(key, log_weights, *flat)
    return jtu.tree_unflatten(treedef, list(out_flat)), logz[0], ess[0]


def ring_systematic_resample(key: jax.Array, log_weights: jax.Array,
                             tree, mesh: Mesh, axis_name="particles",
                             block: int = 256, halo: int | None = None):
    """Deterministic distributed systematic resampling (see
    :func:`ring_resample_step`), returning just the resampled tree."""
    out, _, _ = ring_resample_step(
        key, log_weights, tree, mesh, axis_name, block, halo
    )
    return out


def blocked_stats(log_weights, mesh, axis_name="particles",
                  block: int = 256):
    """``(logZ̄, ESS)`` in ONE ``shard_map`` (one all_gather of block
    sums) with layout-independent summation order."""
    return _blocked_stats_only(log_weights, mesh, axis_name, block)


def _blocked_stats_only(log_weights, mesh, axis_name, block):
    n = log_weights.shape[0]
    n_dev = _mesh_axis_size(mesh, axis_name)

    def local(lw):
        d = lax.axis_index(axis_name)
        (_, _, _, total_raw, _, sum_sq, m) = _blocked_cdf_stats(
            lw, axis_name, n, n_dev, d, block
        )
        logz = m + jnp.log(total_raw) - jnp.log(n)
        ess = total_raw * total_raw / sum_sq
        return logz[None], ess[None]

    logz, ess = jax.shard_map(
        local, mesh=mesh, in_specs=P(axis_name),
        out_specs=(P(axis_name), P(axis_name)), check_vma=False,
    )(log_weights)
    return logz[0], ess[0]


def blocked_logz(log_weights: jax.Array, mesh: Mesh,
                 axis_name="particles", block: int = 256) -> jax.Array:
    """log Z̄ with layout-independent (fixed-block) summation order —
    the deterministic counterpart of :func:`shardmap_logz`."""
    return _blocked_stats_only(log_weights, mesh, axis_name, block)[0]


def blocked_ess(log_weights: jax.Array, mesh: Mesh,
                axis_name="particles", block: int = 256) -> jax.Array:
    """ESS with layout-independent summation order — the deterministic
    counterpart of :func:`shardmap_ess`."""
    return _blocked_stats_only(log_weights, mesh, axis_name, block)[1]
