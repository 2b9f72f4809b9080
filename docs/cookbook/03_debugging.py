"""Cookbook 3 — Debugging probabilistic programs.

Four layers of tooling, from cheapest to deepest (parity with the
reference cookbook's `debugging.ipynb`, reference `docs/cookbook/active/`,
re-designed around this framework's interpreters):

1. **Static sanitizers** — address mistakes caught at trace time.
2. **Staged runtime checks** — `do_checkify` validity checks that run
   *inside* jit (NaN scores, invalid constraints).
3. **Rich rendering** — `pprint`/`render_html` for traces and choice
   maps (lane counts, active switch branches, mask occupancy).
4. **Time-travel debugging** — record intermediate values of a jitted
   computation, jump between frames, substitute values, and replay the
   tail (`core/compiler/interpreters/time_travel.py`).
"""

import jax
import jax.numpy as jnp

import genjax_xla as g
from genjax_xla.core.compiler.interpreters.time_travel import (
    rec,
    time_machine,
)
from genjax_xla.utils import pformat, render_html

key = jax.random.key(0)

# -- 1. sanitizers -------------------------------------------------------
# Using the same address twice is a bug (the second choice would
# silently shadow the first). The DSL raises immediately:
@g.gen
def reused():
    g.normal(0.0, 1.0) @ "x"
    return g.normal(0.0, 1.0) @ "x"


try:
    reused.simulate(key, ())
except g.AddressReuse as e:
    print("AddressReuse caught:", e)

# Assessing with an incomplete choice map (a missing site) is also an
# immediate error — assess scores COMPLETE maps only:
@g.gen
def pair():
    x = g.normal(0.0, 1.0) @ "x"
    return g.normal(x, 1.0) @ "y"


try:
    pair.assess(g.C["x"].set(1.0), ())
except g.MissingAddress as e:
    print("MissingAddress caught:", e)

# -- 2. staged runtime checks -------------------------------------------
# Value-dependent validity cannot be checked at trace time under jit —
# flags are traced arrays. `do_checkify` stages jax.checkify checks
# into the compiled program (zero cost outside the context); errors
# surface when you ask. The classic mistake: unmasking a Mask whose
# flag is (dynamically) False — e.g. reading a switch branch that
# wasn't taken, or a lane past a scan's masked horizon.
from jax.experimental import checkify

dead_value = g.Mask(jnp.asarray(1.0), jnp.asarray(False))
print("silent unmask (checks off):", float(dead_value.unmask()))

with g.do_checkify():
    err, _ = checkify.checkify(dead_value.unmask)()
print("checkify says:", err.get())
assert err.get() is not None  # "unmask called on a Mask with flag False"

# -- 3. rendering --------------------------------------------------------
@g.gen
def branchy(p):
    which = g.flip(p) @ "which"
    return (
        g.switch(
            g.gen(lambda: g.normal(0.0, 1.0) @ "small"),
            g.gen(lambda: g.normal(10.0, 1.0) @ "big"),
        )(jnp.int32(which), (), ())
        @ "value"
    )


tr = branchy.simulate(key, (0.3,))
print(pformat(tr))  # switch branches annotated active/inactive
html = render_html(tr)  # collapsible HTML; save or _repr_html_ in Jupyter
assert "<details" in html
# `genjax_xla.utils.pretty()` installs _repr_html_ on every Pytree, so
# notebooks render traces richly with no further setup.

# -- 4. time travel ------------------------------------------------------
# `rec` marks intermediate values worth recording; `time_machine` runs
# the function once, capturing a frame (value + environment snapshot)
# at each mark. You can then jump around and counterfactually replay.
def pipeline(x):
    a = rec(x * 2.0, name="doubled")
    b = rec(a + 10.0, name="shifted")
    return b * b


dbg = time_machine(pipeline)(3.0)
print("frames:", [f.tag for f in dbg.frames], " final:", float(dbg.final))

dbg.jump("doubled")
print("at 'doubled':", float(dbg.frame.value))

# Counterfactual: what if `doubled` had been 100? Replay the tail only
# (no re-execution of anything before the cursor):
alt = dbg.resume(100.0)
assert float(alt) == (100.0 + 10.0) ** 2
print("counterfactual final:", float(alt))

# And `remix` re-runs from scratch with new inputs, keeping your marks:
dbg2 = dbg.remix(5.0)
assert float(dbg2.final) == (5.0 * 2 + 10.0) ** 2
print("ok")
