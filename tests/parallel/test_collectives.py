"""Explicit-collective path (parallel/collectives.py): agreement with the
global/GSPMD path on the virtual 8-device CPU mesh, and HLO assertions
that collectives (psum/ppermute) — not a full gather of particle state —
implement the communication (VERDICT round-1 item 5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from genjax_xla.inference.smc import (
    effective_sample_size,
    resample_tree,
)
from genjax_xla.parallel.collectives import (
    shardmap_ess,
    shardmap_logz,
    shardmap_systematic_resample,
)
from genjax_xla.parallel.mesh import particle_mesh

N = 1 << 12


@pytest.fixture(scope="module")
def mesh():
    return particle_mesh()


def _weights(key):
    return jax.random.normal(key, (N,)) * 3.0


class TestReductions:
    def test_logz_matches_global(self, mesh):
        lw = _weights(jax.random.key(0))
        from jax.scipy.special import logsumexp

        want = logsumexp(lw) - jnp.log(N)
        got = jax.jit(lambda w: shardmap_logz(w, mesh))(lw)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)

    def test_ess_matches_global(self, mesh):
        lw = _weights(jax.random.key(1))
        want = effective_sample_size(lw)
        got = jax.jit(lambda w: shardmap_ess(w, mesh))(lw)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)

    def test_psum_in_hlo(self, mesh):
        lw = _weights(jax.random.key(0))
        txt = (
            jax.jit(lambda w: shardmap_logz(w, mesh))
            .lower(lw)
            .compile()
            .as_text()
        )
        assert "all-reduce" in txt


class TestDistributedResample:
    def test_matches_global_systematic(self, mesh):
        key = jax.random.key(3)
        lw = _weights(jax.random.key(4))
        xs = jax.random.normal(jax.random.key(5), (N,))
        aux = jax.random.normal(jax.random.key(6), (N, 3))
        want = resample_tree(key, lw, (xs, aux), N, "systematic")
        got = jax.jit(
            lambda k, w, t: shardmap_systematic_resample(k, w, t, mesh)
        )(key, lw, (xs, aux))
        # Same grid, same CDF up to float summation order: ancestor
        # choices may differ only where a grid point lands within an ulp
        # of a CDF boundary — both sides are then valid systematic
        # resamples. Require agreement on all but a handful of slots.
        mism = int(np.sum(np.asarray(want[0]) != np.asarray(got[0])))
        assert mism <= 4, mism
        mism_aux = int(np.sum(np.any(
            np.asarray(want[1]) != np.asarray(got[1]), axis=-1
        )))
        assert mism_aux <= 4, mism_aux

    def test_skewed_weights_cross_shard(self, mesh):
        # All mass on a handful of particles in one shard: every other
        # shard's outputs must come over the ring.
        key = jax.random.key(7)
        lw = jnp.full((N,), -1e9).at[:4].set(jnp.array([0.0, 0.1, 0.2, 0.3]))
        xs = jnp.arange(N, dtype=jnp.float32)
        want = resample_tree(key, lw, xs, N, "systematic")
        got = jax.jit(
            lambda k, w, t: shardmap_systematic_resample(k, w, t, mesh)
        )(key, lw, xs)
        np.testing.assert_array_equal(np.asarray(want), np.asarray(got))

    def test_layout_independence(self, mesh):
        # Pre-sharding the inputs across the mesh changes nothing.
        key = jax.random.key(8)
        lw = _weights(jax.random.key(9))
        xs = jax.random.normal(jax.random.key(10), (N,))
        sh = NamedSharding(mesh, P("particles"))
        lw_s = jax.device_put(lw, sh)
        xs_s = jax.device_put(xs, sh)
        a = shardmap_systematic_resample(key, lw, xs, mesh)
        b = jax.jit(
            lambda k, w, t: shardmap_systematic_resample(k, w, t, mesh)
        )(key, lw_s, xs_s)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_hlo_has_permute_but_no_full_gather_psum_path(self, mesh):
        key = jax.random.key(3)
        lw = _weights(jax.random.key(4))
        xs = jax.random.normal(jax.random.key(5), (N,))
        txt = (
            jax.jit(
                lambda k, w, t: shardmap_systematic_resample(k, w, t, mesh)
            )
            .lower(key, lw, xs)
            .compile()
            .as_text()
        )
        assert "collective-permute" in txt
        # No collective may materialize the full N-particle state on one
        # device: every all-gather/all-reduce output stays O(N/D) or
        # scalar-sized (the D block sums).
        for line in txt.splitlines():
            if "all-gather" in line or "all-reduce" in line:
                assert f"f32[{N}]" not in line, line
                assert f"s32[{N}]" not in line, line


# ---------------------------------------------------------------------------
# Deterministic blocked-CDF product path (VERDICT r2 item 1)
# ---------------------------------------------------------------------------

from genjax_xla.parallel.collectives import (  # noqa: E402
    blocked_ess,
    blocked_logz,
    ring_resample_step,
    ring_systematic_resample,
)


def _mesh_of(d):
    return jax.sharding.Mesh(
        np.asarray(jax.devices()[:d]), ("particles",)
    )


class TestBlockedStats:
    def test_logz_ess_match_global(self):
        lw = _weights(jax.random.key(0))
        from jax.scipy.special import logsumexp

        mesh = _mesh_of(8)
        np.testing.assert_allclose(
            float(blocked_logz(lw, mesh)),
            float(logsumexp(lw) - jnp.log(N)),
            rtol=1e-6,
        )
        np.testing.assert_allclose(
            float(blocked_ess(lw, mesh)),
            float(effective_sample_size(lw)),
            rtol=1e-5,
        )

    def test_bitwise_across_layouts(self):
        lw = _weights(jax.random.key(11))
        vals = [
            (
                float(jax.jit(
                    lambda w, m=_mesh_of(d): blocked_logz(w, m)
                )(lw)),
                float(jax.jit(
                    lambda w, m=_mesh_of(d): blocked_ess(w, m)
                )(lw)),
            )
            for d in (1, 2, 4, 8)
        ]
        assert all(v == vals[0] for v in vals[1:]), vals


class TestRingResampleProduct:
    def test_bitwise_across_layouts(self):
        """The product contract: identical bits on 1/2/4/8-device
        meshes (fixed-block CDF summation; VERDICT r2 item 1)."""
        key = jax.random.key(3)
        lw = _weights(jax.random.key(4))
        xs = jax.random.normal(jax.random.key(5), (N,))
        aux = jax.random.normal(jax.random.key(6), (N, 3))
        outs = []
        for d in (1, 2, 4, 8):
            tree, logz, ess = jax.jit(
                lambda k, w, t, m=_mesh_of(d): ring_resample_step(
                    k, w, t, m
                )
            )(key, lw, (xs, aux))
            outs.append(
                (np.asarray(tree[0]), np.asarray(tree[1]),
                 float(logz), float(ess))
            )
        for o in outs[1:]:
            np.testing.assert_array_equal(o[0], outs[0][0])
            np.testing.assert_array_equal(o[1], outs[0][1])
            assert o[2] == outs[0][2]
            assert o[3] == outs[0][3]

    def test_near_agreement_with_single_device_resampler(self):
        key = jax.random.key(3)
        lw = _weights(jax.random.key(4))
        xs = jax.random.normal(jax.random.key(5), (N,))
        want = resample_tree(key, lw, xs, N, "systematic")
        got = ring_systematic_resample(key, lw, xs, _mesh_of(8))
        mism = int(np.sum(np.asarray(want) != np.asarray(got)))
        assert mism <= 4, mism

    def test_skewed_weights_cross_shard(self):
        key = jax.random.key(7)
        lw = jnp.full((N,), -1e9).at[:4].set(
            jnp.array([0.0, 0.1, 0.2, 0.3])
        )
        xs = jnp.arange(N, dtype=jnp.float32)
        want = resample_tree(key, lw, xs, N, "systematic")
        got = ring_systematic_resample(key, lw, xs, _mesh_of(8))
        np.testing.assert_array_equal(np.asarray(want), np.asarray(got))

    def test_every_slot_filled_stress(self):
        """Offspring-run coverage is a partition of [0, N): every output
        slot is hit exactly once, across many weight seeds."""
        xs = jnp.arange(N, dtype=jnp.float32)
        for seed in range(8):
            lw = _weights(jax.random.key(100 + seed)) * (seed + 1)
            got = ring_systematic_resample(
                jax.random.key(seed), lw, xs, _mesh_of(8)
            )
            # Ancestors are the sorted systematic choice of resample_tree
            # up to ulp boundaries; partition => output is sorted and
            # every value is a valid index.
            a = np.asarray(got)
            assert (np.diff(a) >= 0).all()
            assert (a >= 0).all() and (a < N).all()

    def test_product_step_hlo(self, mesh):
        key = jax.random.key(3)
        lw = _weights(jax.random.key(4))
        xs = jax.random.normal(jax.random.key(5), (N,))
        txt = (
            jax.jit(
                lambda k, w, t: ring_resample_step(k, w, t, mesh)
            )
            .lower(key, lw, xs)
            .compile()
            .as_text()
        )
        assert "collective-permute" in txt
        for line in txt.splitlines():
            if "all-gather" in line or "all-reduce" in line:
                assert f"f32[{N}]" not in line, line
                assert f"s32[{N}]" not in line, line


class TestProductShardedSMC:
    def test_sharded_smc_step_bitwise_across_layouts(self):
        import genjax_xla as g
        from genjax_xla.inference import Target
        from genjax_xla.parallel import sharded_smc_step

        @g.gen
        def bb(a, b):
            p = g.beta(a, b) @ "p"
            v = g.flip(p) @ "v"
            return v

        target = Target(bb, (2.0, 2.0), g.C["v"].set(True))
        key = jax.random.key(314159)
        outs = []
        for d in (1, 8):
            col, logz = jax.jit(
                sharded_smc_step(
                    target, 2048, _mesh_of(d), ess_threshold=1.1
                )
            )(key)
            outs.append(
                (np.asarray(col.get_particles().get_choices()["p"]),
                 float(logz))
            )
        np.testing.assert_array_equal(outs[0][0], outs[1][0])
        assert outs[0][1] == outs[1][1]

    def test_sharded_pf_collective_bitwise_and_hlo(self):
        from genjax_xla.parallel import sharded_particle_filter

        def init(key):
            return jax.random.normal(key), jnp.zeros(())

        def step(key, x, y):
            x_new = 0.9 * x + 0.3 * jax.random.normal(key)
            return x_new, jax.scipy.stats.norm.logpdf(y, x_new, 0.5)

        ys = jnp.asarray([0.1, -0.2, 0.3, 0.0])
        key = jax.random.key(314159)
        res = []
        for d in (1, 8):
            pf = sharded_particle_filter(init, step, N, _mesh_of(d))
            fin, _ = jax.jit(lambda k, p=pf: p(k, ys))(key)
            res.append(
                (np.asarray(fin.particles), float(fin.log_z))
            )
        np.testing.assert_array_equal(res[0][0], res[1][0])
        assert res[0][1] == res[1][1]

        pf = sharded_particle_filter(init, step, N, _mesh_of(8))
        txt = (
            jax.jit(lambda k: pf(k, ys)).lower(key).compile().as_text()
        )
        assert "collective-permute" in txt
        for line in txt.splitlines():
            if "all-gather" in line or "all-reduce" in line:
                assert f"f32[{N}]" not in line, line
                assert f"s32[{N}]" not in line, line


class TestHaloExchange:
    """Halo fast path (round 3): typical resamples move only 2·H
    boundary slots; the ring is the exact fallback. Value-identical to
    the ring for every halo size and layout."""

    def test_halo_sizes_bitwise_equal(self):
        key = jax.random.key(3)
        lw = _weights(jax.random.key(4))
        xs = jax.random.normal(jax.random.key(5), (N,))
        ref = None
        for h in (None, 0, 4, 64, N):
            tree, logz, ess = jax.jit(
                lambda k, w, t, m=_mesh_of(8), hh=h: ring_resample_step(
                    k, w, t, m, halo=hh
                )
            )(key, lw, xs)
            cur = (np.asarray(tree), float(logz), float(ess))
            if ref is None:
                ref = cur
            else:
                np.testing.assert_array_equal(cur[0], ref[0])
                assert cur[1] == ref[1] and cur[2] == ref[2]

    def test_skewed_forces_fallback_still_exact(self):
        key = jax.random.key(7)
        lw = jnp.full((N,), -1e9).at[:4].set(
            jnp.array([0.0, 0.1, 0.2, 0.3])
        )
        xs = jnp.arange(N, dtype=jnp.float32)
        want = resample_tree(key, lw, xs, N, "systematic")
        got = ring_systematic_resample(
            key, lw, xs, _mesh_of(8), halo=8
        )
        np.testing.assert_array_equal(np.asarray(want), np.asarray(got))

    def test_balanced_hlo_comm_is_halo_sized(self):
        """With a halo, the compiled step's collective-permutes carry
        only halo-sized operands (plus the while-loop fallback bodies,
        which carry block-sized ones but execute zero trips)."""
        key = jax.random.key(3)
        lw = _weights(jax.random.key(4))
        xs = jax.random.normal(jax.random.key(5), (N,))
        txt = (
            jax.jit(
                lambda k, w, t: ring_resample_step(
                    k, w, t, _mesh_of(8), halo=64
                )
            )
            .lower(key, lw, xs)
            .compile()
            .as_text()
        )
        assert "collective-permute" in txt
        for line in txt.splitlines():
            if "all-gather" in line or "all-reduce" in line:
                assert f"f32[{N}]" not in line, line
                assert f"s32[{N}]" not in line, line


class TestLayoutFreeBlock:
    """r4 review: the effective block derives from the GLOBAL n and cap
    only — awkward particle counts must work identically per layout
    instead of hard-failing (the r3 strict check) or silently
    re-associating (the pre-r3 shrink)."""

    def test_awkward_n_bitwise_across_layouts(self):
        from genjax_xla.parallel.collectives import blocked_stats
        from jax.sharding import Mesh

        n = 3000  # n/D = 375 on 8 devices; old code raised (block=256)
        lw = jax.random.normal(jax.random.key(30), (n,)) * 2.0
        outs = []
        for d in (1, 2, 4, 8):
            mesh = Mesh(np.asarray(jax.devices()[:d]), ("particles",))
            logz, ess = jax.jit(
                lambda w, m=mesh: blocked_stats(w, m)
            )(lw)
            outs.append((float(logz), float(ess)))
        assert outs.count(outs[0]) == len(outs)
        # And the values agree with plain reductions.
        ref_logz = float(
            jax.scipy.special.logsumexp(lw) - jnp.log(n)
        )
        np.testing.assert_allclose(outs[0][0], ref_logz, rtol=1e-5)

    def test_derivation_is_global_only(self):
        from genjax_xla.parallel.collectives import _layout_free_block

        # Divides n/D for every power-of-two D up to 256.
        for n in (3000, 1 << 20, 4096, 12, 100):
            b = _layout_free_block(n, 256)
            v = (n & -n).bit_length() - 1
            for k in range(0, min(v, 6) + 1):
                assert (n >> k) % b == 0, (n, k, b)

    def test_headline_block_unchanged(self):
        from genjax_xla.parallel.collectives import _layout_free_block

        # The 2^20-particle product path keeps its tuned 256 block.
        assert _layout_free_block(1 << 20, 256) == 256


class TestCommModelExtraction:
    """Pins tools/comm_model.py's HLO collective extraction (the byte
    counts in docs/comm_model.json) against the ring resample
    whose comm structure is already asserted line-by-line above."""

    def test_ring_resample_classification(self):
        import os
        import sys

        sys.path.insert(0, os.path.join(
            os.path.dirname(__file__), "..", "..", "tools"
        ))
        from comm_model import extract_collectives

        n = 1 << 16
        mesh = _mesh_of(8)
        lw = jax.random.normal(jax.random.key(0), (n,))
        xs = jax.random.normal(jax.random.key(1), (n,))
        txt = (
            jax.jit(lambda k, w, t: ring_resample_step(k, w, t, mesh))
            .lower(jax.random.key(2), lw, xs)
            .compile()
            .as_text()
        )
        colls = extract_collectives(txt)
        assert colls, "no collectives extracted"
        uncond_perm = [c["bytes"] for c in colls
                       if c["op"] == "collective-permute"
                       and not c["under_while"]]
        gated_perm = [c["bytes"] for c in colls
                      if c["op"] == "collective-permute"
                      and c["under_while"]]
        # The halo exchange is unconditional and halo-sized (halo =
        # max(256, n/8/16) = 512 lanes, 4 B each); the ring fallback is
        # while-gated and block-sized (n/8 = 8192 lanes).
        assert uncond_perm and max(uncond_perm) <= 512 * 4
        assert gated_perm and max(gated_perm) >= 8192 * 4
        # The blocked-stats all_gather is unconditional: 3*(n/256)*4 B.
        ag = [c["bytes"] for c in colls
              if c["op"] == "all-gather" and not c["under_while"]]
        assert sum(ag) == 3 * (n // 256) * 4
