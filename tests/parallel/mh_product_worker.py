"""Multi-host worker for the PRODUCT entry points (VERDICT r4 item 2):
``sharded_smc_step`` (the ``dryrun_multichip`` path), mesh-sharded NUTS
warmup+sampling (``inference/adaptation.run_nuts``), the time-sharded
FFBS (``parallel/seq.time_sharded_filter``), and particle-sharded SVGD
(``parallel/svgd.run_sharded_svgd``) executed across REAL process
boundaries.

Run as ``python mh_product_worker.py <pid> <nproc> <port> <outdir>
<mode>``: ``4 // nproc`` virtual CPU devices per process form a 4-device
GLOBAL mesh regardless of the process count, so the parent test can
compare outputs BITWISE across 1-process (the oracle), 2-process, and
4-process runs of the identical global program — exercising the failure
modes the in-process mesh cannot (addressable-shard indexing,
cross-process collectives, non-addressable outputs). ``mode`` is
``all`` or ``smc`` (the cheaper 4-process variant).

Each process writes its replicated scalars and the `(start, data)` of
every addressable shard of the sharded outputs to
``outdir/out_<nproc>p_<pid>.npz``; the parent reassembles and compares.
"""

import os
import sys

pid, nproc, port, outdir, mode = (
    int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
    sys.argv[5],
)
n_local = 4 // nproc
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    f"--xla_force_host_platform_device_count={n_local}"
)
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import jax

jax.config.update("jax_platforms", "cpu")
# Shared compile cache across the three runs (same global programs).
jax.config.update("jax_compilation_cache_dir", outdir)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1)

import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from genjax_xla.parallel.bootstrap import init_distributed

if nproc > 1:
    init_distributed(f"127.0.0.1:{port}", nproc, pid)
assert len(jax.devices()) == 4, jax.devices()

import genjax_xla as g
from genjax_xla.inference import Target

out: dict = {}


def save_sharded(name: str, arr) -> None:
    for shard in arr.addressable_shards:
        start = shard.index[0].start or 0
        out[f"{name}@{start}"] = np.asarray(shard.data)


# --- 1. sharded_smc_step: the dryrun_multichip product path ------------
from genjax_xla.parallel.smc import sharded_smc_step

mesh = Mesh(np.asarray(jax.devices()), ("particles",))


@g.gen
def bb(a, b):
    p = g.beta(a, b) @ "p"
    v = g.flip(p) @ "v"
    return v


target = Target(bb, (2.0, 2.0), g.C["v"].set(True))
K = 4096
# threshold > 1: the systematic resample ALWAYS fires, so the ring
# redistribution crosses the process boundary.
step = sharded_smc_step(target, K, mesh, ess_threshold=1.1)
col, logz = jax.jit(step)(jax.random.key(0))
jax.block_until_ready(logz)
out["smc_logz"] = np.asarray(logz)
assert np.isfinite(out["smc_logz"])
ps = col.get_particles().get_choices()["p"]
save_sharded("smc_ps", ps)
save_sharded("smc_lw", col.get_log_weights())

if mode == "all":
    # --- 2. mesh-sharded NUTS warmup + sampling ------------------------
    from genjax_xla.inference import run_nuts

    chain_mesh = Mesh(np.asarray(jax.devices()), ("chains",))

    @g.gen
    def hier():
        mu = g.normal(0.0, 1.0) @ "mu"
        tau = g.normal(0.0, 1.0) @ "tau"
        _ = g.normal(mu, jnp.exp(tau)) @ "y"

    nuts_target = Target(hier, (), g.C["y"].set(1.0))
    chms, infos = jax.jit(
        lambda key: run_nuts(
            nuts_target, key, n_chains=8, num_warmup=10,
            num_samples=10, max_depth=3, mesh=chain_mesh,
            axis_name="chains",
        )
    )(jax.random.key(2))
    jax.block_until_ready(chms)
    mu = chms["mu"]                      # (8, 10) sharded over chains
    save_sharded("nuts_mu", mu)
    # A mesh-wide reduction over a partly NON-addressable array: every
    # process participates, every process gets the replicated scalar.
    out["nuts_mu_mean"] = np.asarray(jnp.mean(mu))
    assert np.isfinite(out["nuts_mu_mean"])

    # --- 3. time-sharded FFBS forward filter ---------------------------
    from genjax_xla.lang.distributions.discrete_hmm import (
        DiscreteHMMConfiguration,
    )
    from genjax_xla.parallel.seq import time_sharded_filter

    time_mesh = Mesh(np.asarray(jax.devices()), ("time",))
    cfg = DiscreteHMMConfiguration.circulant(8, 8)
    obs = np.asarray(
        jax.random.randint(jax.random.key(3), (64,), 0, 8)
    )
    alphas, lz = jax.jit(
        lambda o: time_sharded_filter(cfg, o, time_mesh, block=8)
    )(obs)
    jax.block_until_ready(lz)
    out["ffbs_logz"] = np.asarray(lz)
    assert np.isfinite(out["ffbs_logz"])
    save_sharded("ffbs_alphas", alphas)

    # --- 4. particle-sharded SVGD ------------------------------------
    from genjax_xla.parallel.svgd import run_sharded_svgd

    svgd_mesh = Mesh(np.asarray(jax.devices()), ("particles",))
    xs0 = np.asarray(
        jax.random.normal(jax.random.key(5), (64, 2))
    )
    ens = jax.jit(
        lambda x: run_sharded_svgd(
            lambda z: -0.5 * jnp.sum(z * z), x, n_steps=4,
            step_size=0.1, mesh=svgd_mesh,
        )
    )(xs0)
    jax.block_until_ready(ens)
    save_sharded("svgd_ens", ens)

np.savez(os.path.join(outdir, f"out_{nproc}p_{pid}.npz"), **out)
print(f"MH_PRODUCT_OK {pid}", flush=True)
