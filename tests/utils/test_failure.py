"""Failure detection + elastic recovery (utils/failure.py).

The recovery loop is exercised with a *transient* fault: the state
carries a ``poison`` scalar that injects NaN at one global step; the
test's ``place`` hook clears it on restore (modeling a fault that is
gone after recovery — an SDC, a flaky chip, a bad host buffer).
Elasticity: the restored state is re-placed onto HALF the mesh and the
final result must match the uninterrupted full-mesh run bitwise
(global-step-indexed fold_in keys make the trajectory layout- and
restart-independent).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from genjax_xla.utils.failure import (
    Watchdog,
    all_finite,
    run_elastic,
)

KEY = jax.random.key(0)


def _step(i, state):
    """One SMC-flavored step: propagate particles with step-indexed
    randomness (fold_in by GLOBAL index => restart-independent)."""
    xs, poison = state
    eps = jax.random.normal(jax.random.fold_in(KEY, i), xs.shape)
    xs = 0.9 * xs + 0.1 * eps
    # Transient fault: poison != 0 injects NaN at global step 5.
    xs = xs + jnp.where((i == 5) & (poison != 0.0), jnp.nan, 0.0)
    return xs, poison


def _oracle(n_steps, xs0, tmp_path):
    """The unfailed run, through the SAME chunked executable (eager
    step-by-step replay differs in the last ulp from the fused scan —
    the bitwise claim is restart-independence, not fusion-independence)."""
    res = run_elastic(
        _step, (xs0, jnp.zeros(())), n_steps,
        ckpt_path=str(tmp_path / "oracle.npz"), chunk=4,
    )
    assert res.events == []
    return res.state[0]


class TestAllFinite:
    def test_flags(self):
        assert bool(all_finite({"a": jnp.ones(3), "b": 2.0}))
        assert not bool(all_finite((jnp.ones(3), jnp.asarray(jnp.nan))))
        # int leaves are ignored (isfinite undefined), not crashed on.
        assert bool(all_finite(jnp.arange(3)))


class TestWatchdog:
    def test_expiry(self):
        import time

        with Watchdog(1e-9) as dog:
            time.sleep(0.01)
        assert dog.expired
        with Watchdog(60.0) as dog:
            pass
        assert not dog.expired


class TestRunElastic:
    def test_transient_nan_recovers_bitwise(self, tmp_path):
        xs0 = jax.random.normal(jax.random.key(1), (64,))
        events_places = []

        def place(state, devs):
            events_places.append(len(devs))
            xs, _ = state
            return xs, jnp.zeros(())  # fault cleared on recovery

        res = run_elastic(
            _step, (xs0, jnp.ones(())), 16,
            ckpt_path=str(tmp_path / "ck.npz"),
            chunk=4, max_retries=2, place=place,
        )
        assert len(res.events) == 1
        ev = res.events[0]
        assert ev.kind == "nonfinite"
        assert ev.step == 4 and ev.resumed_from == 4
        # Replayed chunk: 16 productive + 0 counted for the failed chunk.
        assert res.steps_run == 16
        np.testing.assert_array_equal(
            res.state[0], _oracle(16, xs0, tmp_path)
        )

    def test_elastic_downshift_half_mesh(self, tmp_path):
        n_dev = len(jax.devices())
        assert n_dev == 8  # conftest virtual mesh
        full = Mesh(np.asarray(jax.devices()), ("p",))
        half_devs = jax.devices()[: n_dev // 2]
        half = Mesh(np.asarray(half_devs), ("p",))
        xs0 = jax.device_put(
            jax.random.normal(jax.random.key(2), (64,)),
            NamedSharding(full, P("p")),
        )

        def place(state, devs):
            xs, _ = state
            xs = jax.device_put(xs, NamedSharding(half, P("p")))
            return xs, jnp.zeros(())

        res = run_elastic(
            _step, (xs0, jnp.ones(())), 16,
            ckpt_path=str(tmp_path / "ck.npz"),
            chunk=4, max_retries=2,
            devices=lambda: half_devs, place=place,
        )
        assert res.events[0].n_devices == n_dev // 2
        # Post-recovery state lives on the surviving half-mesh...
        assert set(res.state[0].sharding.device_set) == set(half_devs)
        # ...and the trajectory is bitwise that of the unfailed run
        # (full-mesh oracle vs half-mesh recovery: layout-independent).
        np.testing.assert_array_equal(
            np.asarray(res.state[0]),
            np.asarray(_oracle(16, xs0, tmp_path)),
        )

    def test_persistent_failure_gives_up(self, tmp_path):
        def bad_step(i, state):
            raise ValueError("chip on fire")

        with pytest.raises(RuntimeError, match="giving up"):
            run_elastic(
                bad_step, jnp.ones(4), 8,
                ckpt_path=str(tmp_path / "ck.npz"),
                chunk=4, max_retries=2,
            )

    def test_hang_deadline_detected(self, tmp_path):
        with pytest.raises(RuntimeError, match="hang"):
            run_elastic(
                lambda i, s: s + 1.0, jnp.ones(4), 8,
                ckpt_path=str(tmp_path / "ck.npz"),
                chunk=4, max_retries=1, deadline=1e-12,
            )

    def test_checkpoint_cadence_and_resume_point(self, tmp_path):
        """Fault at step 13 with checkpoints every 2 chunks (8 steps):
        recovery resumes from step 8, replaying 8..13."""
        xs0 = jax.random.normal(jax.random.key(3), (16,))

        def step13(i, state):
            xs, poison = state
            xs = xs * 1.001
            xs = xs + jnp.where((i == 13) & (poison != 0.0), jnp.nan, 0.0)
            return xs, poison

        def place(state, devs):
            return state[0], jnp.zeros(())

        res = run_elastic(
            step13, (xs0, jnp.ones(())), 24,
            ckpt_path=str(tmp_path / "ck.npz"),
            chunk=4, checkpoint_every=2, max_retries=2, place=place,
        )
        assert res.events[0].step == 12
        assert res.events[0].resumed_from == 8
        np.testing.assert_allclose(
            np.asarray(res.state[0]), np.asarray(xs0) * 1.001**24,
            rtol=1e-5,
        )

    def test_no_failure_no_events(self, tmp_path):
        xs0 = jnp.ones(8)
        res = run_elastic(
            lambda i, s: s * 2.0, xs0, 8,
            ckpt_path=str(tmp_path / "ck.npz"), chunk=4,
        )
        assert res.events == []
        np.testing.assert_array_equal(res.state, xs0 * 2.0**8)


class TestMeshPlace:
    def test_downshift_sharded_pytree_bitwise(self, tmp_path):
        """run_elastic with the library mesh_place: a sharded multi-leaf
        state pytree (ensemble + log-weights + scalar logz + poison)
        down-shifts 8 -> 4 devices mid-run and replays bitwise
        (VERDICT r2 item 10)."""
        from genjax_xla.utils.failure import mesh_place

        full = Mesh(np.asarray(jax.devices()), ("particles",))
        sh = NamedSharding(full, P("particles"))
        xs0 = jax.device_put(
            jax.random.normal(jax.random.key(5), (64,)), sh
        )
        lw0 = jax.device_put(jnp.zeros(64), sh)
        state0 = {"xs": xs0, "lw": lw0, "logz": jnp.zeros(()),
                  "poison": jnp.ones(())}

        def step(i, state):
            eps = jax.random.normal(
                jax.random.fold_in(KEY, i), state["xs"].shape
            )
            xs = 0.9 * state["xs"] + 0.1 * eps
            lw = state["lw"] - 0.5 * xs**2
            from jax.scipy.special import logsumexp

            logz = state["logz"] + logsumexp(lw) - jnp.log(64.0)
            xs = xs + jnp.where(
                (i == 5) & (state["poison"] != 0.0), jnp.nan, 0.0
            )
            return {"xs": xs, "lw": lw, "logz": logz,
                    "poison": state["poison"]}

        half_devs = jax.devices()[:4]
        base_place = mesh_place("particles")

        def place(state, devs):
            out = base_place(state, devs)
            out["poison"] = jnp.zeros(())  # transient fault cleared
            return out

        res = run_elastic(
            step, state0, 16,
            ckpt_path=str(tmp_path / "ck.npz"),
            chunk=4, max_retries=2,
            devices=lambda: half_devs, place=place,
        )
        assert res.events[0].n_devices == 4
        assert set(res.state["xs"].sharding.device_set) == set(half_devs)
        # scalar leaves replicated, array leaves sharded
        assert set(res.state["logz"].sharding.device_set) == set(half_devs)

        oracle = run_elastic(
            step, {**state0, "poison": jnp.zeros(())}, 16,
            ckpt_path=str(tmp_path / "oracle.npz"), chunk=4,
        )
        for k in ("xs", "lw", "logz"):
            np.testing.assert_array_equal(
                np.asarray(res.state[k]), np.asarray(oracle.state[k])
            )

    def test_particle_collection_placement(self):
        """mesh_place re-lays a real ParticleCollection pytree."""
        from genjax_xla.utils.failure import mesh_place
        import genjax_xla as g
        from genjax_xla.inference import ImportanceK, Target

        @g.gen
        def bb(a, b):
            p = g.beta(a, b) @ "p"
            v = g.flip(p) @ "v"
            return v

        target = Target(bb, (2.0, 2.0), g.C["v"].set(True))
        col = ImportanceK(target, k_particles=64).run_smc(KEY)
        devs = jax.devices()[:4]
        placed = mesh_place("particles")(col, devs)
        assert set(placed.get_log_weights().sharding.device_set) == set(
            devs
        )
        np.testing.assert_array_equal(
            np.asarray(placed.get_log_weights()),
            np.asarray(col.get_log_weights()),
        )

    def test_min_devices_guard(self):
        from genjax_xla.utils.failure import mesh_place

        with pytest.raises(RuntimeError, match="min_devices"):
            mesh_place("particles", min_devices=9)(
                jnp.ones(8), jax.devices()
            )


class TestCrossTopologyElastic:
    @pytest.mark.filterwarnings(
        "error:Sharding info not provided")
    def test_orbax_downshift_real_smc_ensemble(self, tmp_path):
        """End-to-end VERDICT r4 missing #3: a sharded SMC-style
        ensemble checkpoints through the ORBAX (sharding-aware) path on
        the 8-device mesh, hits a transient fault, restores directly
        onto the surviving 4-device topology via mesh_place, and
        continues to the bitwise-identical posterior state."""
        from jax.scipy.special import logsumexp

        from genjax_xla.utils.failure import mesh_place

        n = 64
        full = Mesh(np.asarray(jax.devices()), ("particles",))
        sh = NamedSharding(full, P("particles"))
        state0 = {
            "xs": jax.device_put(
                jax.random.normal(jax.random.key(7), (n,)), sh
            ),
            "lw": jax.device_put(jnp.zeros(n), sh),
            "logz": jnp.zeros(()),
            "poison": jnp.ones(()),
        }

        def step(i, state):
            k = jax.random.fold_in(KEY, i)
            xs = 0.8 * state["xs"] + 0.2 * jax.random.normal(k, (n,))
            lw = state["lw"] - 0.5 * (xs - 1.0) ** 2
            logz = state["logz"] + logsumexp(lw) - jnp.log(float(n))
            xs = xs + jnp.where(
                (i == 6) & (state["poison"] != 0.0), jnp.nan, 0.0
            )
            return {"xs": xs, "lw": lw, "logz": logz,
                    "poison": state["poison"]}

        half_devs = jax.devices()[:4]
        base_place = mesh_place("particles")

        def place(state, devs):
            out = base_place(state, devs)
            out["poison"] = jnp.zeros(())
            return out

        # Orbax directory path (no .npz suffix) => the sharding-aware
        # backend; the restore template is ALREADY on the 4-device mesh
        # (run_elastic places it before restoring).
        res = run_elastic(
            step, state0, 16,
            ckpt_path=str(tmp_path / "orbax_ck"),
            chunk=4, max_retries=2,
            devices=lambda: half_devs, place=place,
        )
        assert [e.kind for e in res.events] == ["nonfinite"]
        assert res.events[0].n_devices == 4
        assert set(res.state["xs"].sharding.device_set) == set(half_devs)

        oracle = run_elastic(
            step, {**state0, "poison": jnp.zeros(())}, 16,
            ckpt_path=str(tmp_path / "oracle_ck"), chunk=4,
        )
        assert oracle.events == []
        for k in ("xs", "lw", "logz"):
            np.testing.assert_array_equal(
                np.asarray(res.state[k]), np.asarray(oracle.state[k])
            )


class TestRecoveryGuard:
    def test_recovery_failure_counts_as_retry(self, tmp_path):
        """Review r5: a failing place() hook (checkpoint unreadable,
        devices vanishing mid-restore) must count against max_retries
        and surface as a 'recovery_failed' event — not escape."""
        calls = {"n": 0}

        def bad_place(state, devs):
            calls["n"] += 1
            raise OSError("checkpoint store unreachable")

        with pytest.raises(RuntimeError, match="giving up"):
            run_elastic(
                lambda i, s: s + jnp.nan, jnp.ones(4), 8,
                ckpt_path=str(tmp_path / "ck.npz"),
                chunk=4, max_retries=2, place=bad_place,
            )
        assert calls["n"] >= 1
