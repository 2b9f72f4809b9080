"""A/B timings behind the formulation choices of the GPU bring-up.

Each experiment times its variants interleaved (every round runs each
variant once, in reversed order on odd rounds) after two warm-up calls,
each call ended by ``block_until_ready``, and prints one JSON line with
the median seconds, every time and a correctness check. On a GPU the
first line is the card's name and power limit.

Experiments (all by default):

- ``resample``: systematic expansion at 2^20 particles — ancestor
  indices + row gather (the library's ``resample_tree``), ``jnp.repeat``
  of the offspring counts and, with ``--parent``, the earlier blocked
  expansion — alone (scalar and (N, 64) leaves) and end to end in the
  2^20 x 32 tracking filter (benchmark config 4).
- ``cdf``: the offspring CDF as XLA ``cumsum`` + ``cummax`` against a
  rows-then-offsets form (rows of 16 or 32 summed left to right), alone
  and in the tracking filter.
- ``logmatmul``: ``log_matmul`` at ``Precision.HIGHEST`` vs ``DEFAULT``,
  batched, S in {128, 512, 1024}, and the parallel HMM filter (S=256,
  T=1024) at each precision against the sequential one.
- ``hmm``: the HMM bootstrap filter at config-3 size (S=64, T=64, 2^19
  particles) selecting transition rows by gather vs one-hot matmul.
- ``smc2``: SMC² at 1024 x 1024, T=50 — this tree's sort path and, with
  ``--parent``, the earlier fused interval-contraction path.
- ``trace``: a ``jax.profiler`` trace of the tracking filter with and
  without resampling, written under ``--trace-dir``, summarised as
  device busy time and the costliest kernels per run.
- ``seed_kernels`` (needs ``--parent``): run once each Pallas kernel
  of the earlier tree that the bring-up removed, and print what stops
  it on this device.

``--parent DIR`` is an unpacked checkout of the tree before the GPU
bring-up (its package has the former name). ``--small`` shrinks every
size so that the script runs on the CPU.

Usage: python benchmarks/gpu_ab.py [--small] [--parent DIR]
       [--trace-dir DIR] [experiment ...]
"""

from __future__ import annotations

import argparse
import collections
import functools
import glob
import importlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import jax.tree_util as jtu  # noqa: E402
import numpy as np  # noqa: E402
from jax import lax  # noqa: E402

EXPERIMENTS = ("resample", "cdf", "logmatmul", "hmm", "smc2", "trace",
               "seed_kernels")


def emit(**kw):
    print(json.dumps(kw), flush=True)


def ab(fns: dict, args: dict, rounds: int = 5):
    """Interleaved medians: ``({name: median_s}, {name: [ms, ...]})``."""
    for name, f in fns.items():
        jax.block_until_ready(f(*args[name]))
        jax.block_until_ready(f(*args[name]))
    ts = {name: [] for name in fns}
    names = list(fns)
    for r in range(rounds):
        for name in names if r % 2 == 0 else names[::-1]:
            t0 = time.perf_counter()
            jax.block_until_ready(fns[name](*args[name]))
            ts[name].append(time.perf_counter() - t0)
    return ({k: float(np.median(v)) for k, v in ts.items()},
            {k: [round(x * 1e3, 4) for x in v] for k, v in ts.items()})


def same_args(fns, *args):
    return {k: args for k in fns}


def parent_module(parent: str | None, name: str):
    """``<former package>.<name>`` from the ``--parent`` checkout, or
    None without one."""
    if parent is None:
        return None
    pkg = next(d for d in sorted(os.listdir(parent))
               if d.startswith("genjax_")
               and os.path.isfile(os.path.join(parent, d, "__init__.py")))
    return importlib.import_module(f"{pkg}.{name}")


def tracking_filter(n: int, resample_fn=None, ess_threshold: float = 0.5):
    """Benchmark config 4's model: jitted ``key -> log Z`` over 32 steps."""
    from genjax_xla.inference.pf import particle_filter

    ys = jax.random.normal(jax.random.key(9), (32,)) * 5.0

    def init(key):
        return jax.random.normal(key, (n,)), jnp.zeros((n,))

    def step(key, xs, y):
        xs = (0.5 * xs + 25.0 * xs / (1.0 + xs * xs)
              + jnp.sqrt(10.0) * jax.random.normal(key, (n,)))
        return xs, jax.scipy.stats.norm.logpdf(y, xs * xs / 20.0, 1.0)

    pf = particle_filter(init, step, n, batched=True,
                         ess_threshold=ess_threshold,
                         resample_fn=resample_fn)
    return jax.jit(lambda key: pf(key, ys)[0].log_z)


# ---------------------------------------------------------------------------


def exp_resample(small: bool, parent: str | None):
    from genjax_xla.inference.smc import (
        _ancestors_from_counts,
        systematic_offspring_counts,
        systematic_offspring_cumulative,
    )

    n = 1 << (12 if small else 20)
    old = parent_module(parent, "ops.resample")

    def ancestors_gather(key, lw, tree):
        idx = _ancestors_from_counts(
            systematic_offspring_cumulative(key, lw, n), n)
        return jtu.tree_map(lambda v: v[idx], tree)

    def repeat(key, lw, tree):
        c = systematic_offspring_counts(key, lw, n)
        return jtu.tree_map(lambda v: jnp.repeat(
            v, c, axis=0, total_repeat_length=n), tree)

    forms = {"i_ancestors_gather": ancestors_gather, "ii_repeat": repeat}
    if old is not None:
        forms["iii_blocked_expand"] = lambda key, lw, tree: (
            old.expand_by_cumulative(
                tree, systematic_offspring_cumulative(key, lw, n), n))

    key = jax.random.key(5)
    lw = 2.0 * jax.random.normal(jax.random.key(6), (n,))
    for shape in ((n,), (n, 64)):
        x = jax.random.normal(jax.random.key(7), shape)
        fns = {k: jax.jit(f) for k, f in forms.items()}
        outs = {k: np.asarray(f(key, lw, x)) for k, f in fns.items()}
        bitwise = {k: bool(np.array_equal(o, outs["ii_repeat"]))
                   for k, o in outs.items()}
        med, times = ab(fns, same_args(fns, key, lw, x))
        emit(exp="resample_alone", n=n, leaf=list(shape), median_s=med,
             bitwise_equal_to_repeat=bitwise, times_ms=times)

    fns = {k: tracking_filter(n, f) for k, f in forms.items()}
    fns["no_resampling"] = tracking_filter(n, ess_threshold=0.0)
    med, times = ab(fns, same_args(fns, jax.random.key(0)))
    emit(exp="resample_in_tracking_filter", n=n, steps=32, median_s=med,
         times_ms=times)


def _rows_cumsum(w, b: int):
    """Monotone cumulative sum: rows of ``b`` summed left to right, row
    offsets from the same scan over row totals, each row clamped into
    its interval."""
    if w.shape[0] <= b:
        cols = [w[0]]
        for j in range(1, w.shape[0]):
            cols.append(cols[-1] + w[j])
        return jnp.stack(cols)
    pad = (-w.shape[0]) % b
    rows = jnp.pad(w, (0, pad)).reshape(-1, b)
    cols = [rows[:, 0]]
    for j in range(1, b):
        cols.append(cols[-1] + rows[:, j])
    loc = jnp.stack(cols, axis=1)
    ends = _rows_cumsum(loc[:, -1], b)
    starts = jnp.concatenate([jnp.zeros(1, ends.dtype), ends[:-1]])
    cum = jnp.clip(starts[:, None] + loc, starts[:, None], ends[:, None])
    return cum.reshape(-1)[:w.shape[0]]


def _rows_offspring_cumulative(key, lw, n, b):
    cum = _rows_cumsum(jnp.exp(lw - jnp.max(lw)), b)
    u0 = jax.random.uniform(key, ())
    cc = jnp.clip(jnp.ceil(cum * (n / cum[-1]) - u0), 0, n).astype(jnp.int32)
    return cc.at[-1].set(n)


def exp_cdf(small: bool, parent: str | None):
    from genjax_xla.inference.smc import (
        _ancestors_from_counts,
        systematic_offspring_cumulative,
    )

    n = 1 << (12 if small else 20)
    variants = {"xla": systematic_offspring_cumulative}
    for b in (16, 32):
        variants[f"rows{b}"] = functools.partial(
            _rows_offspring_cumulative, b=b)
    key = jax.random.key(5)
    weights = {
        "normal2": 2.0 * jax.random.normal(jax.random.key(6), (n,)),
        "head_tail": jnp.where(jnp.arange(n) < 8, 10.0, -2.0),
        "one_hot": jnp.where(jnp.arange(n) == 389, 0.0, -1e9),
    }
    for name, lw in weights.items():
        fns = {k: jax.jit(lambda a, w, f=f: f(a, w, n))
               for k, f in variants.items()}
        outs = {k: np.asarray(f(key, lw)).astype(np.int64)
                for k, f in fns.items()}
        check = {k: {"monotone": bool((np.diff(o) >= 0).all()),
                     "last": int(o[-1]),
                     "max_abs_diff_vs_xla": int(np.abs(o - outs["xla"]).max())}
                 for k, o in outs.items()}
        med, times = ab(fns, same_args(fns, key, lw))
        emit(exp="cdf_alone", weights=name, n=n, median_s=med, check=check,
             times_ms=times)

    fns = {k: tracking_filter(n, lambda kk, lw, xs, f=f: xs[
        _ancestors_from_counts(f(kk, lw, n), n)]) for k, f in variants.items()}
    fns["no_resampling"] = tracking_filter(n, ess_threshold=0.0)
    med, times = ab(fns, same_args(fns, jax.random.key(0)))
    emit(exp="cdf_in_tracking_filter", n=n, steps=32, median_s=med,
         times_ms=times)


def _log_matmul_at(x, y, precision):
    """The library's ``log_matmul`` with the matmul precision as an
    argument (the library pins ``HIGHEST``)."""
    rx = jnp.max(x, axis=-1, keepdims=True)
    cy = jnp.max(y, axis=-2, keepdims=True)
    p = jnp.matmul(jnp.exp(x - rx), jnp.exp(y - cy), precision=precision)
    return jnp.log(jnp.maximum(p, jnp.finfo(p.dtype).tiny)) + rx + cy


def exp_logmatmul(small: bool, parent: str | None):
    from genjax_xla.inference.exact_testbed import sample_problem
    from genjax_xla.lang.distributions.discrete_hmm import (
        DiscreteHMMConfiguration,
        forward_filter,
    )
    from genjax_xla.ops.logmatmul import log_matmul

    x0 = jax.random.normal(jax.random.key(0), (2, 8, 8))
    assert np.array_equal(np.asarray(log_matmul(x0, x0)), np.asarray(
        _log_matmul_at(x0, x0, lax.Precision.HIGHEST)))
    precisions = {"HIGHEST": lax.Precision.HIGHEST,
                  "DEFAULT": lax.Precision.DEFAULT}
    for s, b in ((16, 4),) if small else ((128, 256), (512, 64), (1024, 16)):
        x = jax.random.normal(jax.random.key(1), (b, s, s)) * 2
        y = jax.random.normal(jax.random.key(2), (b, s, s)) * 2
        fns = {k: jax.jit(functools.partial(_log_matmul_at, precision=p))
               for k, p in precisions.items()}
        ref = np.asarray(fns["HIGHEST"](x, y), np.float64)
        diff = {k: float(np.max(np.abs(np.asarray(f(x, y), np.float64) - ref)))
                for k, f in fns.items()}
        med, times = ab(fns, same_args(fns, x, y))
        emit(exp="log_matmul", S=s, batch=b, median_s=med,
             max_abs_diff_vs_highest=diff, times_ms=times)

    s, t = (16, 64) if small else (256, 1024)
    config = DiscreteHMMConfiguration.circulant(s, s)
    obs = sample_problem(jax.random.key(3), config, t).observations
    a_seq, lz_seq = jax.jit(lambda o: forward_filter(config, o))(obs)

    def parallel(prec):
        def f(o):
            obs_ll = config.observation_logits[:, o].T
            ms = config.transition_logits[None] + obs_ll[1:, None, :]
            prefix = lax.associative_scan(
                functools.partial(_log_matmul_at, precision=prec), ms)
            alpha0 = config.prior_logits + obs_ll[0]
            rest = jax.scipy.special.logsumexp(
                alpha0[None, :, None] + prefix, axis=1)
            alphas = jnp.concatenate([alpha0[None], rest], 0)
            return alphas, jax.scipy.special.logsumexp(alphas[-1])
        return jax.jit(f)

    fns = {k: parallel(p) for k, p in precisions.items()}
    errors = {}
    for k, f in fns.items():
        a, lz = f(obs)
        errors[k] = {
            "l1": float(jnp.max(jnp.sum(jnp.abs(
                jax.nn.softmax(a, -1) - jax.nn.softmax(a_seq, -1)), -1))),
            "log_marginal_rel_error":
                abs(float(lz) - float(lz_seq)) / abs(float(lz_seq)),
        }
    med, times = ab(fns, same_args(fns, obs))
    emit(exp="hmm_parallel_precision", S=s, T=t, median_s=med, errors=errors,
         times_ms=times)


def exp_hmm(small: bool, parent: str | None):
    from genjax_xla.inference.exact_testbed import sample_problem
    from genjax_xla.inference.pf import particle_filter
    from genjax_xla.lang.distributions.discrete_hmm import (
        DiscreteHMMConfiguration,
        forward_filter,
    )

    s, t, n = (16, 16, 1 << 10) if small else (64, 64, 1 << 19)
    config = DiscreteHMMConfiguration.circulant(s, s)
    obs = sample_problem(jax.random.key(3), config, t).observations
    exact = float(forward_filter(config, obs)[1])
    trans_cdf = jnp.cumsum(jax.nn.softmax(config.transition_logits, -1), -1)

    def rows(mode, table, idx):
        if mode == "gather":
            return table[idx]
        oh = (idx[:, None] == lax.broadcasted_iota(
            jnp.int32, (1, table.shape[0]), 1)).astype(table.dtype)
        prec = (lax.Precision.HIGHEST if mode == "onehot_highest"
                else lax.Precision.DEFAULT)
        return jnp.dot(oh, table, precision=prec,
                       preferred_element_type=jnp.float32)

    def build(mode, sampling):
        ol = config.observation_logits

        def emission(z, o):
            return rows(mode, ol[:, o][:, None], z)[:, 0]

        def init(key):
            z = jax.random.categorical(key, config.prior_logits, shape=(n,))
            return z, emission(z, obs[0])

        def step(key, zs, o):
            if sampling == "invcdf":
                u = jax.random.uniform(key, (n, 1))
                z = jnp.minimum(jnp.sum(rows(mode, trans_cdf, zs) < u, -1),
                                s - 1).astype(zs.dtype)
            else:
                z = jax.random.categorical(
                    key, rows(mode, config.transition_logits, zs), axis=-1)
            return z, emission(z, o)

        pf = particle_filter(init, step, n, batched=True)
        return jax.jit(lambda key: pf(key, obs[1:])[0].log_z)

    for sampling in ("invcdf", "gumbel"):
        fns = {m: build(m, sampling)
               for m in ("gather", "onehot_default", "onehot_highest")}
        errors = {m: abs(float(f(jax.random.key(5))) - exact)
                  for m, f in fns.items()}
        med, times = ab(fns, same_args(fns, jax.random.key(5)))
        emit(exp="hmm_filter_selection", sampling=sampling, S=s, T=t, n=n,
             median_s=med, logz_abs_error=errors, times_ms=times)


def exp_smc2(small: bool, parent: str | None):
    from genjax_xla.inference import smc2
    from genjax_xla.models import lgssm_grid_posterior, simulate_lgssm_data

    q, r = 0.4, 0.4
    ys = simulate_lgssm_data(jax.random.key(11), 0.7, q, r, 50)[1]
    nt = 32 if small else 1024
    model = (
        lambda key, a, n: jnp.sqrt(q) * jax.random.normal(key, (n,)),
        lambda key, a, xs: a * xs + jnp.sqrt(q) * jax.random.normal(
            key, xs.shape),
        lambda a, xs, y: jax.scipy.stats.norm.logpdf(y, xs, jnp.sqrt(r)),
        lambda key: jax.random.uniform(key, minval=-0.95, maxval=0.95),
        lambda a: jnp.where(jnp.abs(a) < 0.95, -jnp.log(1.9), -jnp.inf),
    )
    runs = {"sort": smc2(*model, n_theta=nt, n_x=nt, proposal=0.15)}
    old = parent_module(parent, "inference.smc2")
    if old is not None:
        runs["fused_parent"] = old.smc2(*model, n_theta=nt, n_x=nt,
                                        proposal=0.15, inner_impl="fused")
    fns = {k: jax.jit(lambda key, run=run: run(key, ys).log_z)
           for k, run in runs.items()}
    exact = float(lgssm_grid_posterior(
        ys, q, r, jnp.linspace(-0.949, 0.949, 191))[2])
    errors = {k: abs(float(f(jax.random.key(1))) - exact)
              for k, f in fns.items()}
    med, times = ab(fns, same_args(fns, jax.random.key(1)), rounds=4)
    emit(exp="smc2_inner_resampling", n_theta=nt, n_x=nt, T=50,
         median_s=med, logz_abs_error=errors, times_ms=times)


def exp_trace(small: bool, parent: str | None, trace_dir: str):
    n = 1 << (12 if small else 20)
    for name, thr in (("resampling", 0.5), ("no_resampling", 0.0)):
        f = tracking_filter(n, ess_threshold=thr)
        for i in range(3):
            jax.block_until_ready(f(jax.random.key(i)))
        d = os.path.join(trace_dir, "trace_" + name)
        with jax.profiler.trace(d):
            for i in range(3):
                jax.block_until_ready(f(jax.random.key(10 + i)))
        path = sorted(glob.glob(os.path.join(
            d, "plugins/profile/*/*.xplane.pb")))[-1]
        per = collections.defaultdict(lambda: [0, 0.0])
        spans = []
        for plane in jax.profiler.ProfileData.from_file(path).planes:
            if not plane.name.startswith("/device:GPU"):
                continue
            for line in plane.lines:
                if "stream" not in line.name.lower():
                    continue
                for ev in line.events:
                    per[ev.name][0] += 1
                    per[ev.name][1] += ev.duration_ns / 1e3
                    spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
        spans.sort()
        busy, cur = 0, None
        for s, e in spans:
            if cur is None or s > cur[1]:
                busy += 0 if cur is None else cur[1] - cur[0]
                cur = [s, e]
            else:
                cur[1] = max(cur[1], e)
        busy += 0 if cur is None else cur[1] - cur[0]
        top = sorted(per.items(), key=lambda kv: -kv[1][1])[:40]
        emit(exp="trace_tracking_filter", filter=name, n=n, runs=3,
             busy_us_per_run=busy / 3e3,
             top_kernels_us_per_run=[[k, c / 3, round(t / 3, 2)]
                                     for k, (c, t) in top])


def exp_seed_kernels(small: bool, parent: str | None):
    if parent is None:
        raise SystemExit("gpu_ab: seed_kernels needs --parent DIR")
    n_pf, n = (1 << 16, 1 << 20) if not small else (1 << 10, 1 << 12)

    def fused_filter():
        pf = parent_module(parent, "inference.pf").fused_particle_filter(
            lambda k: jax.random.normal(k, (n_pf,)),
            lambda x, e: 0.5 * x + e, lambda x, y: -0.5 * (y - x) ** 2, n_pf)
        return jax.jit(lambda k: pf(k, jnp.zeros(8))[0].log_z)(
            jax.random.key(0))

    def cdf_counts():
        return parent_module(parent, "ops.cdf_counts") \
            .systematic_cumulative_pallas(jax.random.key(0), jnp.zeros(n), n,
                                          chunk_rows=512)

    def log_matmul_pallas():
        x = jnp.zeros((4, 256, 256))
        return parent_module(parent, "ops.logmatmul").log_matmul_pallas(x, x)

    def expand_adaptive():
        smc = parent_module(parent, "inference.smc")
        cc = smc.systematic_offspring_cumulative(
            jax.random.key(0), jnp.zeros(n), n)
        return parent_module(parent, "ops.expand_adaptive").expand_adaptive(
            jnp.zeros(n), cc, n)

    for name, fn in (("fused_particle_filter", fused_filter),
                     ("cdf_counts", cdf_counts),
                     ("log_matmul_pallas S=256", log_matmul_pallas),
                     ("expand_adaptive", expand_adaptive)):
        try:
            jax.block_until_ready(fn())
            emit(exp="seed_kernel", kernel=name, ran=True)
        except Exception as e:  # report what stops each kernel, then go on
            lines = str(e).strip().splitlines()
            emit(exp="seed_kernel", kernel=name, ran=False,
                 error=type(e).__name__, first_line=lines[0][:300]
                 if lines else "")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("experiments", nargs="*",
                    help="any of: " + ", ".join(EXPERIMENTS))
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--parent", default=None,
                    help="unpacked checkout of the tree before the bring-up")
    ap.add_argument("--trace-dir", default=None,
                    help="where the trace experiment writes its profiles")
    args = ap.parse_args(argv)
    unknown = set(args.experiments) - set(EXPERIMENTS)
    if unknown:
        ap.error(f"unknown experiments {sorted(unknown)}")
    todo = list(args.experiments) or [
        e for e in EXPERIMENTS
        if (e != "trace" or args.trace_dir)
        and (e != "seed_kernels" or args.parent)]
    if args.parent:
        sys.path.insert(0, os.path.abspath(args.parent))

    from genjax_xla.utils.profiling import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform == "gpu":
        enable_compile_cache()
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=60,
        ).stdout.strip(), flush=True)
    emit(platform=dev.platform, kind=dev.device_kind, experiments=todo)
    for e in todo:
        if e == "trace":
            if not args.trace_dir:
                raise SystemExit("gpu_ab: trace needs --trace-dir DIR")
            exp_trace(args.small, args.parent, args.trace_dir)
        else:
            globals()["exp_" + e](args.small, args.parent)
    return 0


if __name__ == "__main__":
    sys.exit(main())
