"""Cookbook 5 — Conditionals and masking: stochastic structure under jit.

Under `jax.jit` every program has ONE static shape — you cannot add or
remove random choices at runtime. The framework's answer (same design
space as the reference's `conditionals.ipynb` / `masking.ipynb`,
reference `docs/cookbook/inactive/expressivity/`) is:

- `switch`: all branches exist in the compiled program, the index picks
  which one is *live*; dead branches score 0 and their choices are
  masked out.
- `mask` / `Mask`: a value plus a boolean flag. Flag-False choices
  contribute 0 to the score — "not there" without changing shapes.
- `or_else`: boolean sugar over `switch`.
- `masked_iterate`: scan with a per-step validity flag — variable-length
  sequences at a static maximum length.

Note: this is why the whole framework stays jit-compatible — a
switch lowers to `lax.cond`/`select` (no host round-trip), masks lower
to `where`, and the compiled program never sees dynamic shapes.
"""

import jax
import jax.numpy as jnp

import genjax_xla as g

key = jax.random.key(0)


# -- switch: branch-structured models ------------------------------------
@g.gen
def null_model():
    return g.normal(0.0, 1.0) @ "effect"


@g.gen
def alt_model():
    return g.normal(3.0, 1.0) @ "effect"


sw = g.switch(null_model, alt_model)
# Args: (branch index, branch-0 args, branch-1 args).
tr = jax.jit(sw.simulate)(key, (jnp.asarray(1), (), ()))
print("live branch score:", float(tr.get_score()))

# The choices of the dead branch exist but are masked; reading through
# the trace gives you a Mask — check the flag before trusting the value:
v = tr.get_choices()["effect"]
v = v.unmask() if isinstance(v, g.Mask) else v
print("effect:", float(v))

# Model selection: put a prior ON the index and infer it.
@g.gen
def selector():
    use_alt = g.flip(0.5) @ "use_alt"
    return sw(jnp.int32(use_alt), (), ()) @ "m"


obs = g.C["m", "effect"].set(2.9)
keys = jax.random.split(key, 2048)
trs, ws = jax.jit(jax.vmap(
    lambda k: selector.generate(k, obs, ())
))(keys)
post = jnp.exp(ws - jax.scipy.special.logsumexp(ws))
p_alt = jnp.sum(post * trs.get_choices()["use_alt"])
print("P(alt | effect=2.9) ≈", float(p_alt))
assert p_alt > 0.9  # 2.9 is 2.9σ from branch 0's mean, 0.1σ from 1's

# -- or_else -------------------------------------------------------------
oe = alt_model.or_else(null_model)
tr_t = oe.simulate(key, (True, (), ()))   # takes alt_model
tr_f = oe.simulate(key, (False, (), ()))  # takes null_model
print("or_else retvals:", float(tr_t.get_retval()), float(tr_f.get_retval()))

# -- mask: optional observations -----------------------------------------
# A sensor that sometimes drops readings: the model always HAS the
# site, the flag says whether it counts.
@g.gen
def reading(x):
    return g.normal(x, 0.1) @ "y"


masked_reading = reading.mask()
tr_on = masked_reading.simulate(key, (True, 1.0))
tr_off = masked_reading.simulate(key, (False, 1.0))
assert float(tr_off.get_score()) == 0.0  # dropped reading: no evidence
assert float(tr_on.get_score()) != 0.0
print("masked scores:", float(tr_on.get_score()), float(tr_off.get_score()))

# -- masked_iterate: ragged sequences, static shapes ---------------------
# Five time steps allocated, but only the flagged ones execute — the
# standard trick for batching sequences of different lengths.
@g.gen
def walk_step(x):
    return g.normal(x + 1.0, 1e-3) @ "x"


mit = walk_step.masked_iterate_final()
flags = jnp.array([True, True, True, False, False])  # length-3 sequence
tr_seq = mit.simulate(key, (0.0, flags))
print("3 live steps from 0.0 →", float(tr_seq.get_retval()))
assert abs(float(tr_seq.get_retval()) - 3.0) < 0.1
print("ok")
