"""Multi-host worker for tests/parallel/test_multihost.py.

Run as ``python mh_worker.py <pid> <nproc> <port>``; each process owns 2
virtual CPU devices, joins the gloo process group through
``genjax_xla.parallel.bootstrap.init_distributed``, and executes the
explicit-collective SMC reductions over the GLOBAL 2×2-device mesh.
Every process verifies its own addressable output shard against a
numpy oracle of the full computation and prints ``MH_OK <pid>``.

This executes the real cross-process path (jax.distributed + gloo
collectives) that a multi-host deployment uses — the closest a single
host can get to a multi-host run (SURVEY §2.3 "multi-host bootstrap"
row).
"""

import os
import sys

pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from genjax_xla.parallel.bootstrap import (
    init_distributed,
    is_multihost,
    local_particle_slice,
)
from genjax_xla.parallel.collectives import (
    shardmap_ess,
    shardmap_logz,
    shardmap_systematic_resample,
)

init_distributed(f"127.0.0.1:{port}", nproc, pid)
assert is_multihost()
assert jax.process_count() == nproc
assert len(jax.devices()) == 2 * nproc  # global devices across processes

N = 1024
mesh = Mesh(np.asarray(jax.devices()), ("particles",))
sharding = NamedSharding(mesh, P("particles"))

# Full global arrays are deterministic from seeds, so every process can
# build the numpy oracle; only the LOCAL slice is fed to jax.
rng = np.random.default_rng(7)
lw_full = rng.normal(size=(N,)).astype(np.float32)
xs_full = rng.normal(size=(N,)).astype(np.float32)
lo, hi = local_particle_slice(N)
lw = jax.make_array_from_process_local_data(sharding, lw_full[lo:hi], (N,))
xs = jax.make_array_from_process_local_data(sharding, xs_full[lo:hi], (N,))

logz = shardmap_logz(lw, mesh)
ess = shardmap_ess(lw, mesh)
key = jax.random.key(3)
xs_new = shardmap_systematic_resample(key, lw, xs, mesh)
jax.block_until_ready((logz, ess, xs_new))

# Oracle (numpy, full arrays).
m = lw_full.max()
w = np.exp(lw_full - m)
logz_exp = m + np.log(w.sum()) - np.log(N)
ess_exp = w.sum() ** 2 / (w * w).sum()
p = w / w.sum()
u0 = float(jax.random.uniform(key, ()))  # same key => same u0 everywhere
counts_cum = np.clip(np.ceil(N * np.cumsum(p) - u0), 0, N).astype(np.int64)
ancestors = np.searchsorted(counts_cum, np.arange(N), side="right")
xs_exp = xs_full[ancestors]

np.testing.assert_allclose(float(logz.addressable_data(0)), logz_exp, rtol=1e-5)
np.testing.assert_allclose(float(ess.addressable_data(0)), ess_exp, rtol=1e-4)
# Each process checks the output shards it owns (together: full coverage).
for shard in xs_new.addressable_shards:
    start = shard.index[0].start or 0
    got = np.asarray(shard.data)
    np.testing.assert_allclose(got, xs_exp[start : start + got.shape[0]],
                               rtol=1e-6)

print(f"MH_OK {pid}", flush=True)
