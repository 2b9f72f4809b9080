"""Cookbook 4 — Speed gains: assess → generate → edit → incremental edit.

Iterative algorithms (MH sweeps, SMC rejuvenation, annealing) revisit
the same model thousands of times with *small* changes. The GFI gives
you four tools, each asymptotically cheaper than the last on a model
with S sites (parity with the reference cookbook's `speed_gains.ipynb`
narrative, reference `docs/cookbook/inactive/update/3_speed_gains.ipynb`,
measured here on this framework's implementations):

| tool                      | work per one-site change |
|---------------------------|--------------------------|
| re-assess the whole map   | O(S) always              |
| generate from constraints | O(S) always              |
| edit, coarse handler      | O(changed site + everything after it) |
| edit, fine-grained (Diff) | O(changed site + true dependents)     |

The fine-grained path (`lang/static_edit.py`) stages the body once and
propagates per-value change tangents, so a site is re-scored only if a
value actually feeding it changed — the reference gets this from its
jaxpr Diff interpreter (reference `interpreters/incremental.py:316-346`);
here it runs as a staged `site_p` program under the same incremental
interpreter. See `benchmarks/incremental_micro.py` for wall-clock
numbers (4.9x on a 100-site chain of 8192-dim sites on host CPU).
"""

import jax
import jax.numpy as jnp

import genjax_xla as g
from genjax_xla.lang import static as static_mod

S = 30
key = jax.random.key(0)


@g.gen
def chain():
    x = g.normal(0.0, 1.0) @ "x0"
    for i in range(1, S):
        x = g.normal(x, 1.0) @ f"x{i}"
    return x


tr = chain.simulate(key, ())

# One MH move = change ONE site. The naive way rebuilds everything:
proposed = g.C[f"x{S // 2}"].set(0.0) | tr.get_choices()
naive_score, _ = chain.assess(proposed, ())       # O(S): re-scores all S

# The edit way asks the trace to move — and returns the MH log-ratio
# directly as the weight (no by-hand score subtraction):
new_tr, w, _rd, bwd = tr.edit(
    jax.random.key(1), g.Update(g.C[f"x{S // 2}"].set(0.0))
)
assert jnp.allclose(new_tr.get_score(), naive_score, atol=1e-5)
assert jnp.allclose(w, new_tr.get_score() - tr.get_score(), atol=1e-5)
print("edit weight == Δscore:", float(w))

# How much WORK did each approach trace? Count compiled-program
# equations (what the chip actually executes):
def eqns(f, *args):
    return len(jax.make_jaxpr(f)(*args).jaxpr.eqns)


n_assess = eqns(lambda c: chain.assess(c, ())[0], proposed)

static_mod.FINE_GRAINED_EDITS = False
n_coarse = eqns(
    lambda k: tr.edit(k, g.Update(g.C[f"x{S // 2}"].set(0.0)))[1],
    jax.random.key(1),
)
static_mod.FINE_GRAINED_EDITS = True
n_fine = eqns(
    lambda k: tr.edit(k, g.Update(g.C[f"x{S // 2}"].set(0.0)))[1],
    jax.random.key(1),
)
print(f"traced equations: assess={n_assess} coarse_edit={n_coarse} "
      f"fine_edit={n_fine}")
# The coarse handler re-scores every site after the edit (~S/2 here);
# the fine path re-scores exactly two sites (the edited one and its
# single dependent) no matter where in the chain the edit lands:
assert n_fine < n_coarse < n_assess

# The same machinery powers Regenerate (MH-within-Gibbs), and composes
# with jit — a whole sweep is one compiled program:
@jax.jit
def mh_sweep(key, trace):
    total = 0.0
    for i in range(S):
        key, sub = jax.random.split(key)
        trace, w, _rd, _bwd = trace.edit(sub, g.Regenerate(g.S.at[f"x{i}"]))
        total = total + w
    return trace, total


tr2, tot = mh_sweep(jax.random.key(2), tr)
print("one jitted sweep, total log-ratio:", float(tot))

# Where it really pays: wide sites. Each re-score is then real FLOPs,
# and O(S) vs O(1) per move is the difference between a sweep that
# scales quadratically and one that scales linearly with model size.
# (Benchmarked in benchmarks/incremental_micro.py; run it yourself:
#   python benchmarks/incremental_micro.py --small)
print("ok")
