"""MH-sweep microbenchmark: fine-grained vs coarse ``@gen`` edits.

VERDICT r1 item 6 done-criterion: "an MH-sweep microbenchmark on a
100-site chain model shows the asymptotic win". One MH sweep =
Regenerate each of the S sites of the chain x0 → x1 → … once. Under the
coarse handler rule every site after the edited one is re-scored (O(S)
per move, O(S²) per sweep); the fine-grained path
(``lang/static_edit.py``) re-scores only the edited site and its one
dependent (O(1) per move, O(S) per sweep).

Two views, both printed as JSON lines:

- **Traced-work scaling**: jaxpr equation count of a middle-site
  Regenerate at S ∈ {25, 50, 100} — coarse grows linearly in S, fine is
  flat. This is the compiled program size, i.e. what the chip executes.
- **Sweep wall time** at S=100 (whole sweep jitted as one program,
  median of reps; run with the default backend).

Usage: ``python benchmarks/incremental_micro.py [--small]``
"""

from __future__ import annotations

import json
import sys
import time

import jax
import jax.numpy as jnp

import genjax_xla as g
from genjax_xla.gfi.requests import Regenerate
from genjax_xla.lang import static as static_mod


def make_chain(s: int, d: int = 1):
    """S-site chain; each site is a ``d``-dim diagonal normal (score
    summed over coordinates), so one site re-score costs O(d) FLOPs —
    at d=1 XLA fuses the coarse path's redundant scalar re-scores to
    noise, so the wall-time comparison uses wide sites."""
    zero = 0.0 if d == 1 else jnp.zeros(d)

    @g.gen
    def chain():
        x = g.normal(zero, 1.0) @ "x0"
        for i in range(1, s):
            x = g.normal(x, 1.0) @ f"x{i}"
        return x

    return chain


def _mid_edit_eqns(s: int, fine: bool) -> int:
    """Jaxpr equation count of one middle-site Regenerate."""
    chain = make_chain(s)
    tr = chain.simulate(jax.random.key(0), ())
    static_mod.FINE_GRAINED_EDITS = fine
    try:
        jaxpr = jax.make_jaxpr(
            lambda k: tr.edit(k, Regenerate(g.S.at[f"x{s // 2}"]))[1]
        )(jax.random.key(1))
    finally:
        static_mod.FINE_GRAINED_EDITS = True
    return len(jaxpr.jaxpr.eqns)


def _sweep_time(s: int, fine: bool, d: int = 1, reps: int = 5) -> float:
    """Median wall time of one full jitted MH sweep (S Regenerate moves,
    always-accept) over the S-site chain of d-dim sites."""
    chain = make_chain(s, d)
    tr = chain.simulate(jax.random.key(0), ())
    static_mod.FINE_GRAINED_EDITS = fine
    try:
        def sweep(key):
            t = tr
            total_w = 0.0
            for i in range(s):
                key, sub = jax.random.split(key)
                t, w, _rd, _bwd = t.edit(sub, Regenerate(g.S.at[f"x{i}"]))
                total_w = total_w + w
            return t.get_score(), total_w

        run = jax.jit(sweep)
        out = run(jax.random.key(1))
        jax.block_until_ready(out)  # compile + warm
        times = []
        for r in range(reps):
            t0 = time.perf_counter()
            out = run(jax.random.key(2 + r))
            jax.block_until_ready(out)
            times.append(time.perf_counter() - t0)
    finally:
        static_mod.FINE_GRAINED_EDITS = True
    times.sort()
    return times[len(times) // 2]


def main() -> None:
    small = "--small" in sys.argv
    sizes = (10, 20) if small else (25, 50, 100)
    scaling = {}
    for s in sizes:
        scaling[s] = {
            "fine_eqns": _mid_edit_eqns(s, fine=True),
            "coarse_eqns": _mid_edit_eqns(s, fine=False),
        }
    s_big = sizes[-1]
    d = 64 if small else 8192
    t_fine = _sweep_time(s_big, fine=True, d=d)
    t_coarse = _sweep_time(s_big, fine=False, d=d)
    print(json.dumps({
        "metric": f"mh_sweep_chain{s_big}x{d}_incremental_speedup",
        "value": round(t_coarse / t_fine, 3),
        "unit": "x (coarse/fine wall time, one jitted sweep)",
        "t_fine_ms": round(t_fine * 1e3, 3),
        "t_coarse_ms": round(t_coarse * 1e3, 3),
        "mid_edit_eqns_d1": scaling,
    }))


if __name__ == "__main__":
    main()
