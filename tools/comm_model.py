"""HLO-extracted communication footprint of the product sharded
programs: the bytes each collective moves, a property of the compiled
program and not of the device it runs on.

For each product entry point this compiles the per-step program on a
D-device virtual CPU mesh and parses the compiled HLO for collective
instructions (the technique pinned by
``tests/parallel/test_collectives.py::test_balanced_hlo_comm_is_halo_sized``
and ``test_sharded_svgd.py``), recording every collective's operand
bytes and whether it sits inside a ``while`` body (the early-exit ring
fallback executes ZERO trips on balanced resamples; scan-carried loops
execute once per step — annotated per program below). Running at two
device counts checks the per-device volumes scale as expected.

Usage::

    python tools/comm_model.py            # prints the table, writes
                                          # docs/comm_model.json

The JSON is the falsifiable artifact: a profiled multi-device run can
diff its per-step transfer volumes against these numbers.
"""

from __future__ import annotations

import json
import os
import re
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault(
    "XLA_FLAGS", "--xla_force_host_platform_device_count=8"
)
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

_DTYPE_BYTES = {
    "pred": 1, "u8": 1, "s8": 1, "bf16": 2, "f16": 2, "u16": 2,
    "s16": 2, "f32": 4, "s32": 4, "u32": 4, "f64": 8, "s64": 8,
    "u64": 8,
}

_COLLECTIVES = (
    "collective-permute", "all-gather", "all-reduce", "all-to-all",
    "reduce-scatter",
)

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")


def _shape_bytes(type_str: str) -> int:
    """Total bytes of an HLO result type (sums tuple elements)."""
    total = 0
    for dt, dims in _SHAPE_RE.findall(type_str):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def extract_collectives(hlo_text: str) -> list[dict]:
    """All collective instructions in compiled HLO: op kind, result
    bytes, enclosing computation, and whether that computation is a
    ``while`` body/condition (conditionally executed)."""
    # Computation headers sit at column 0 ("%name (params) -> type {",
    # entry prefixed "ENTRY"); instructions are indented.
    comp = None
    comp_of_line: list[tuple[str, str]] = []
    for line in hlo_text.splitlines():
        if line and not line[0].isspace() and "{" in line:
            m = re.match(r"(?:ENTRY\s+)?%?([\w.\-]+)\s*\(", line)
            if m:
                comp = m.group(1)
        comp_of_line.append((comp or "?", line))

    while_comps: set[str] = set()
    for _c, line in comp_of_line:
        if "while(" in line:
            for key in ("body=", "condition="):
                m = re.search(key + r"%?([\w.\-]+)", line)
                if m:
                    while_comps.add(m.group(1))

    out = []
    for c, line in comp_of_line:
        s = line.strip()
        # "%name = <result type, may be a tuple with spaces> op(...)"
        m = re.match(
            r"(?:ROOT\s+)?%?[\w.\-]+\s*=\s*(.+?)\s*([a-z][\w\-]*)\(", s
        )
        if not m:
            continue
        type_str, op = m.groups()
        base = op.split(".")[0]
        if base not in _COLLECTIVES:
            continue
        out.append({
            "op": base,
            "bytes": _shape_bytes(type_str),
            "computation": c,
            "under_while": c in while_comps,
        })
    return out


def _compiled_text(fn, *args) -> str:
    return jax.jit(fn).lower(*args).compile().as_text()


# --- Program builders (one per product entry point) --------------------

def prog_pf_resample(devs) -> tuple[str, dict]:
    """One ring resample of the headline PF (2^20 particles, state +
    log-weights): the ENTIRE per-step comm of config 4 — propagation and
    weighting are embarrassingly parallel, and the resample fires ~70%
    of steps."""
    from genjax_xla.parallel.collectives import ring_resample_step

    n = 1 << 20
    mesh = Mesh(np.asarray(devs), ("particles",))
    lw = jax.random.normal(jax.random.key(0), (n,))
    xs = jax.random.normal(jax.random.key(1), (n,))
    txt = _compiled_text(
        lambda k, w, t: ring_resample_step(k, w, t, mesh),
        jax.random.key(2), lw, xs,
    )
    return txt, {"n": n, "fires_per_step": 0.7,
                 "while_note": "early-exit ring fallback: 0 trips on "
                               "balanced resamples (halo covers)"}


def prog_smc_step(devs) -> tuple[str, dict]:
    """The dryrun_multichip sharded SMC step (2^16 particles, forced
    resample)."""
    import genjax_xla as g
    from genjax_xla.inference import Target
    from genjax_xla.parallel.smc import sharded_smc_step

    @g.gen
    def bb(a, b):
        p = g.beta(a, b) @ "p"
        v = g.flip(p) @ "v"
        return v

    target = Target(bb, (2.0, 2.0), g.C["v"].set(True))
    mesh = Mesh(np.asarray(devs), ("particles",))
    step = sharded_smc_step(target, 1 << 16, mesh, ess_threshold=1.1)
    txt = _compiled_text(step, jax.random.key(0))
    return txt, {"n": 1 << 16, "fires_per_step": 1.0,
                 "while_note": "ring fallback (0 trips balanced)"}


def prog_nuts_warmup(devs) -> tuple[str, dict]:
    """Mesh-sharded NUTS (config 2 shape, shrunk iterations): the only
    comm is the cross-chain adaptation stats — O(scalars) per warmup
    window, independent of model size."""
    import genjax_xla as g
    from genjax_xla.inference import Target, run_nuts

    n_pts = 128
    xs = jnp.linspace(-1.0, 1.0, n_pts)
    ys = 2.0 * xs - 0.5

    @g.gen
    def reg(xs):
        slope = g.normal(0.0, 2.0) @ "slope"
        icept = g.normal(0.0, 2.0) @ "icept"
        _ = g.mv_normal_diag(
            slope * xs + icept, 0.2 * jnp.ones_like(xs)
        ) @ "ys"

    target = Target(reg, (xs,), g.C["ys"].set(ys))
    mesh = Mesh(np.asarray(devs), ("chains",))
    txt = _compiled_text(
        lambda key: run_nuts(
            target, key, n_chains=8 * len(devs), num_warmup=8,
            num_samples=4, max_depth=3, mesh=mesh,
        ),
        jax.random.key(0),
    )
    return txt, {"n": 8 * len(devs), "fires_per_step": 1.0,
                 "while_note": "warmup/transition loops: collectives "
                               "inside run once per warmup iteration"}


def prog_ffbs(devs) -> tuple[str, dict]:
    """Time-sharded FFBS forward filter (T=1024, S=64): comm is the
    block-summary all_gather — O(T/block · S²) once per SEQUENCE, never
    the per-step states."""
    from genjax_xla.lang.distributions.discrete_hmm import (
        DiscreteHMMConfiguration,
    )
    from genjax_xla.parallel.seq import time_sharded_filter

    cfg = DiscreteHMMConfiguration.circulant(64, 64)
    T = 1024
    mesh = Mesh(np.asarray(devs), ("time",))
    obs = np.zeros((T,), np.int32)
    txt = _compiled_text(
        lambda o: time_sharded_filter(cfg, o, mesh), obs
    )
    return txt, {"n": T, "fires_per_step": 1.0,
                 "while_note": "per-sequence program (no per-step comm)"}


def prog_svgd_step(devs) -> tuple[str, dict]:
    """One sharded SVGD update (config 10 shape: 4096 particles, D=64):
    positions+gradients all-gathered (O(N·D)), kernel math local."""
    from genjax_xla.parallel.svgd import run_sharded_svgd

    mesh = Mesh(np.asarray(devs), ("particles",))
    xs0 = jax.random.normal(jax.random.key(0), (4096, 64))
    txt = _compiled_text(
        lambda x: run_sharded_svgd(
            lambda z: -0.5 * jnp.sum(z * z), x, n_steps=1,
            step_size=0.1, mesh=mesh,
        ),
        xs0,
    )
    return txt, {"n": 4096, "fires_per_step": 1.0,
                 "while_note": "scan body: collectives run once per "
                               "SVGD step"}


PROGRAMS = {
    "pf_resample_2e20": prog_pf_resample,
    "smc_step_2e16": prog_smc_step,
    "nuts_warmup": prog_nuts_warmup,
    "ffbs_T1024_S64": prog_ffbs,
    "svgd_step_4096x64": prog_svgd_step,
}


def summarize(colls: list[dict]) -> dict:
    uncond = sum(c["bytes"] for c in colls if not c["under_while"])
    cond = sum(c["bytes"] for c in colls if c["under_while"])
    by_op: dict = {}
    for c in colls:
        key = c["op"] + ("(while)" if c["under_while"] else "")
        by_op[key] = by_op.get(key, 0) + c["bytes"]
    return {
        "n_collectives": len(colls),
        "uncond_bytes": uncond,
        "while_bytes": cond,
        "by_op": by_op,
    }


def main() -> None:
    devices = jax.devices()
    results: dict = {}
    for name, builder in PROGRAMS.items():
        results[name] = {}
        for d in (4, 8):
            txt, meta = builder(devices[:d])
            colls = extract_collectives(txt)
            s = summarize(colls)
            s.update(meta)
            results[name][f"D{d}"] = s
            print(
                f"{name:22s} D={d}: {s['n_collectives']:3d} collectives, "
                f"uncond {s['uncond_bytes']:>12,} B, "
                f"while-gated {s['while_bytes']:>12,} B  {s['by_op']}"
            )
    out_path = os.path.join(
        os.path.dirname(__file__), "..", "docs", "comm_model.json"
    )
    with open(out_path, "w") as f:
        json.dump(results, f, indent=1)
    print(f"# wrote {os.path.normpath(out_path)}")


if __name__ == "__main__":
    main()
