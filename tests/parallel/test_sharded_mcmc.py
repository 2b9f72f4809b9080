"""Sharded chain-axis MCMC (VERDICT r2 item 5): NUTS/HMC with the chain
axis laid out over the 8-device CPU mesh — bitwise layout independence vs
the plain vmap path, and HLO assertions that cross-chain warmup
adaptation lowers to small-partial collectives (never a gather of the
(chains, D) positions).

The cross-chain coupling (accept-prob mean, Welford moments) runs through
``inference.adaptation._cross_chain_stats`` — fixed-block summation +
an all_gather of O(chains/block) partials — so the adaptation trajectory
is bitwise identical for ANY layout. Per-chain math is embarrassingly
parallel; its bitwise stability across shard widths additionally depends
on backend codegen (on the CPU test backend, gradient codegen of some
transcendentals differs by 1 ulp at width 8 — pinned at the widths where
codegen is stable, all widths for pure-normal models)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import genjax_xla as g
from genjax_xla.inference import Target, run_nuts
from genjax_xla.inference.adaptation import (
    _cross_chain_stats,
    warmup_chains,
)

KEY = jax.random.key(314159)


def _mesh_of(d):
    return Mesh(np.asarray(jax.devices()[:d]), ("chains",))


@g.gen
def normal_model():
    mu = g.normal(0.0, 1.0) @ "mu"
    tau = g.normal(0.0, 1.0) @ "tau"
    _ = g.normal(mu, jnp.exp(tau)) @ "y"


@g.gen
def gamma_model():
    mu = g.normal(0.0, 1.0) @ "mu"
    sig = g.gamma(2.0, 2.0) @ "sig"
    _ = g.normal(mu, sig) @ "y"


class TestCrossChainStats:
    def test_bitwise_all_layouts(self):
        zs = jax.random.normal(jax.random.key(0), (64, 5))
        acc = jax.random.uniform(jax.random.key(1), (64,))
        outs = []
        for d in (None, 1, 2, 4, 8):
            mesh = None if d is None else _mesh_of(d)
            s = jax.jit(
                lambda z, a, m=mesh: _cross_chain_stats(z, a, m, "chains")
            )(zs, acc)
            outs.append(tuple(np.asarray(x) for x in s))
        for o in outs[1:]:
            for a, b in zip(o, outs[0]):
                np.testing.assert_array_equal(a, b)

    def test_awkward_chain_counts_work_layout_free(self):
        """The group size derives from the GLOBAL chain count only
        (ADVICE r3 + r4 review): counts that are not multiples of the
        cap (12, 20, 100) must WORK — matching plain reductions — not
        hard-fail, and the derived group must be identical per layout."""
        for n in (12, 20, 100):
            zs = jax.random.normal(jax.random.key(n), (n, 2))
            acc = jax.random.uniform(jax.random.fold_in(
                jax.random.key(n), 1), (n,))
            mean_b, m2_b, a_mean = _cross_chain_stats(
                zs, acc, None, "chains", block=8
            )
            np.testing.assert_allclose(
                np.asarray(mean_b), np.asarray(zs.mean(axis=0)),
                rtol=1e-5,
            )
            np.testing.assert_allclose(
                float(a_mean), float(acc.mean()), rtol=1e-5
            )

    def test_small_per_device_chain_count_bitwise(self):
        """chains/D below the cap (16 chains over 8 devices: 2 per
        device) must stay BITWISE equal to the vmap path — the r4 review
        caught the old min(block, c_loc) clamp silently re-associating
        here."""
        from jax.sharding import Mesh

        n = 16
        zs = jax.random.normal(jax.random.key(5), (n, 2))
        acc = jax.random.uniform(jax.random.key(6), (n,))
        want = _cross_chain_stats(zs, acc, None, "chains")
        for d in (2, 8):
            mesh = Mesh(np.asarray(jax.devices()[:d]), ("chains",))
            got = _cross_chain_stats(zs, acc, mesh, "chains")
            for a, b in zip(got, want):
                np.testing.assert_array_equal(
                    np.asarray(a), np.asarray(b)
                )

    def test_matches_plain_reductions(self):
        zs = jax.random.normal(jax.random.key(2), (64, 3))
        acc = jax.random.uniform(jax.random.key(3), (64,))
        mean_b, m2_b, a_mean = _cross_chain_stats(
            zs, acc, None, "chains"
        )
        np.testing.assert_allclose(
            np.asarray(mean_b), np.asarray(jnp.mean(zs, axis=0)),
            rtol=1e-5, atol=1e-7,
        )
        np.testing.assert_allclose(
            np.asarray(m2_b),
            np.asarray(jnp.sum((zs - jnp.mean(zs, 0)) ** 2, 0)),
            rtol=1e-5,
        )
        np.testing.assert_allclose(
            float(a_mean), float(jnp.mean(acc)), rtol=1e-6
        )


class TestWarmupSharded:
    def test_warmup_bitwise_all_layouts(self):
        def logd(z):
            return -0.5 * jnp.sum(z**2) - 0.1 * jnp.sum(z**4)

        z0 = jax.random.normal(jax.random.key(0), (64, 3))
        outs = []
        for d in (None, 1, 4, 8):
            mesh = None if d is None else _mesh_of(d)
            w = jax.jit(
                lambda z, k, m=mesh: warmup_chains(
                    logd, z, k, num_warmup=25, max_depth=4, mesh=m
                )
            )(z0, jax.random.key(2))
            outs.append(tuple(np.asarray(x) for x in w))
        for o in outs[1:]:
            for a, b in zip(o, outs[0]):
                np.testing.assert_array_equal(a, b)

    def test_warmup_hlo_small_collectives_only(self):
        """Cross-chain adaptation communicates O(chains/block) partials:
        no all-gather/all-reduce may carry the (chains, D) positions."""
        n_chains, d_z = 256, 4

        def logd(z):
            return -0.5 * jnp.sum(z**2)

        z0 = jax.random.normal(jax.random.key(0), (n_chains, d_z))
        mesh = _mesh_of(8)
        txt = (
            jax.jit(
                lambda z, k: warmup_chains(
                    logd, z, k, num_warmup=10, max_depth=3, mesh=mesh
                )
            )
            .lower(z0, jax.random.key(1))
            .compile()
            .as_text()
        )
        gathers = [
            line for line in txt.splitlines()
            if "all-gather" in line or "all-reduce" in line
        ]
        assert gathers, "expected explicit collectives in warmup HLO"
        for line in gathers:
            assert f"f32[{n_chains}," not in line, line
            assert f"f32[{n_chains}]" not in line, line


class TestShardedNUTS:
    @pytest.mark.parametrize("layouts", [(None, 1, 4, 8)])
    def test_normal_model_bitwise_all_layouts(self, layouts):
        target = Target(normal_model, (), g.C["y"].set(1.0))
        kw = dict(n_chains=64, num_warmup=40, num_samples=40, max_depth=5)
        outs = []
        for d in layouts:
            mesh = None if d is None else _mesh_of(d)
            chms, _ = jax.jit(
                lambda k, m=mesh: run_nuts(target, k, mesh=m, **kw)
            )(KEY)
            outs.append(
                (np.asarray(chms["mu"]), np.asarray(chms["tau"]))
            )
        for o in outs[1:]:
            np.testing.assert_array_equal(o[0], outs[0][0])
            np.testing.assert_array_equal(o[1], outs[0][1])
        # Statistical sanity: posterior of mu near 0.8 analytic value
        # is model-specific; just require finite spread.
        assert np.isfinite(outs[0][0]).all()

    def test_gamma_model_bitwise_stable_widths(self):
        """Constrained (gamma) latent: bitwise across vmap/1/2/4-device
        layouts. Width-8 per-chain gradient codegen differs by 1 ulp on
        the CPU backend (documented backend artifact, not cross-chain
        coupling — the adaptation stats above are bitwise at all D)."""
        target = Target(gamma_model, (), g.C["y"].set(1.0))
        kw = dict(
            n_chains=64, num_warmup=40, num_samples=40, max_depth=5,
            transforms="auto",
        )
        outs = []
        for d in (None, 2, 4):
            mesh = None if d is None else _mesh_of(d)
            chms, _ = jax.jit(
                lambda k, m=mesh: run_nuts(target, k, mesh=m, **kw)
            )(KEY)
            outs.append(
                (np.asarray(chms["mu"]), np.asarray(chms["sig"]))
            )
        for o in outs[1:]:
            np.testing.assert_array_equal(o[0], outs[0][0])
            np.testing.assert_array_equal(o[1], outs[0][1])
        assert (outs[0][1] > 0).all()


class TestShardedHMC:
    def test_multichain_hmc_bitwise(self):
        """1024-chain HMC with the chain axis sharded over the mesh vs
        plain vmap — bitwise (per-chain fold_in keys, no cross-chain
        coupling)."""
        from genjax_xla.gfi.choice_map import ChoiceMap
        from genjax_xla.inference.mcmc import mh
        from genjax_xla.inference.requests.hmc import HMC
        from genjax_xla.parallel.mesh import shard_leading_axis

        target = Target(normal_model, (), g.C["y"].set(1.0))
        n_chains, n_steps = 1024, 10

        def build(mesh):
            constrain = (
                (lambda t: t) if mesh is None
                else (lambda t: shard_leading_axis(t, mesh, "chains"))
            )

            def run(key):
                keys = jax.vmap(
                    lambda c: jax.random.fold_in(key, c)
                )(jnp.arange(n_chains))
                trs, _ = jax.vmap(
                    lambda k: target.importance(k, ChoiceMap.empty())
                )(keys)
                trs = constrain(trs)

                def one_chain(k, tr):
                    def step(tr, i):
                        new, _acc = mh(
                            jax.random.fold_in(k, i), tr,
                            HMC(g.S.at["mu"] | g.S.at["tau"], 0.05, 5),
                        )
                        return new, new.get_choices()["mu"]

                    return jax.lax.scan(step, tr, jnp.arange(n_steps))

                _, mus = jax.vmap(one_chain)(keys, trs)
                return mus

            return run

        a = jax.jit(build(None))(KEY)
        b = jax.jit(build(_mesh_of(8)))(KEY)
        assert len(b.sharding.device_set) == 8
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
