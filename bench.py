"""Benchmark harness: every config of ``benchmarks/run_all.py`` on one
GPU, headline first, one JSON line each of the form
``{"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
"device": {...}}``.

Headline metric (config 4): bootstrap particle filter on the nonlinear
1-D tracking model — 1,048,576 particles x 32 time steps, the whole
filter (propagation, weighting, ESS, adaptive systematic resampling) in
ONE jitted ``lax.scan``. Unit: particle-steps/s. ``vs_baseline`` is the
ratio to the host-CPU throughput of the identical program
(``benchmarks/baseline_cpu.json``).

The harness runs on a GPU only: on any other device it exits non-zero
and prints no result. A config that fails stops the run with its
exception.

Usage: python bench.py
"""

import json
import os
import sys

import jax

#: Config order: the headline (4), then throughput-bound configs, the
#: matmul-bound trio (8: logreg NUTS, 9: BNN VI, 10: SVGD), then the
#: latency-bound ones.
CONFIG_ORDER = (4, 3, 5, 8, 9, 10, 2, 6, 7, 1)


def main() -> int:
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: needs a GPU, JAX found {dev.platform!r}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from benchmarks.run_all import load_baseline, run_config
    from genjax_xla.utils.profiling import enable_compile_cache

    enable_compile_cache()
    baseline = load_baseline()
    for c in CONFIG_ORDER:
        print(json.dumps(run_config(c, False, baseline)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
