"""Cookbook 9 — measuring honestly: timing a jitted inference program.

No reference counterpart. Three rules make a timing mean what it says,
on any backend:

1. **One ``jit``.** Put the whole program — here a batch of SIR runs —
   inside one jitted function, so the measurement is of one compiled
   executable and not of Python dispatching many small ones.
2. **Warm up first.** The first call with each new shape traces and
   compiles; time only the calls after it, and report compile time
   separately.
3. **Wait for the device.** JAX dispatch is asynchronous: a call returns
   before the device has finished. End every timed call with
   ``jax.block_until_ready`` on its result, inside the timed region.

Compare two versions of a program only within one process on one
device, alternating which runs first, and look at the spread of
repeated runs before trusting a difference. This example prints no
numbers as claims: the timings below depend on the machine running it.
"""

import time

import jax
import numpy as np

import genjax_xla as g
from genjax_xla.inference import ImportanceK, Target
from genjax_xla.utils.profiling import Timed


@g.gen
def bb(a, b):
    p = g.beta(a, b) @ "p"
    v = g.flip(p) @ "v"
    return v


target = Target(bb, (2.0, 2.0), g.C["v"].set(True))
alg = ImportanceK(target, k_particles=64)


# Rule 1: the whole batch of 256 SIR runs is one jitted program.
@jax.jit
def posterior_means(key):
    keys = jax.random.split(key, 256)
    return jax.vmap(lambda k: alg.random_weighted(k, target)[1]["p"])(keys)


# Rule 2: the first call compiles; time it apart from the steady state.
key = jax.random.key(4)
t0 = time.perf_counter()
jax.block_until_ready(posterior_means(key))
compile_and_first_run_s = time.perf_counter() - t0

# Rule 3: every timed call ends in block_until_ready (Timed does it).
timed = Timed(posterior_means)
times = []
for i in range(5):
    means = timed(jax.random.fold_in(key, i))
    times.append(timed.last_s)
median_s = float(np.median(times))

# The numbers are only as good as the result they time: check it.
assert abs(float(means.mean()) - 0.6) < 0.05

# For where the time goes inside one call, trace it:
#   from genjax_xla.utils.profiling import profile_trace
#   with profile_trace("trace_dir"):
#       jax.block_until_ready(posterior_means(key))
print("cookbook 9 ok:", float(means.mean()),
      f"compile+first {compile_and_first_run_s:.3f}s, median {median_s:.4f}s")
