"""Cookbook 2 — Choice maps: building, reading, combining.

A ChoiceMap is the random database of a trace: a mapping from addresses
(the `@ "name"` labels in a model) to values. Observations, constraints,
and posterior samples are all choice maps. This page is the algebra
tour — parity with the reference cookbook's `choice_maps.ipynb`
(reference `docs/cookbook/active/`); implementation
`genjax_xla/gfi/choice_map.py` (reference `choice_map.py`).
"""

import jax
import jax.numpy as jnp

import genjax_xla as g
from genjax_xla.utils import pformat

# -- building ------------------------------------------------------------
# The builder `g.C` creates maps address-by-address; `|` merges.
c1 = g.C["x"].set(1.0)                        # one scalar choice
c2 = g.C["obs", "y"].set(jnp.ones(3))         # nested address ("obs", "y")
c3 = g.ChoiceMap.kw(a=0.5, b=2.0)             # from keywords
c4 = g.ChoiceMap.from_mapping([("u", 1.0), (("v", "w"), 2.0)])
merged = c1 | c2 | c3 | c4
print(pformat(merged))

# Reading uses indexing; nested addresses chain.
assert merged["x"] == 1.0
assert merged["obs", "y"].shape == (3,)
assert merged["v", "w"] == 2.0

# Missing addresses raise (a static error, not a silent None):
try:
    merged["nope"]
except g.ChoiceMapNoValueAtAddress:
    print("missing address raises ChoiceMapNoValueAtAddress")

# `|` is a PRIORITY union: the left side wins at overlapping addresses.
override = g.C["x"].set(99.0) | merged
assert override["x"] == 99.0

# -- filtering by selection ----------------------------------------------
# Selections (`g.S`) describe address sets; filter keeps the selected
# part. Complement with `~`.
sel = g.S.at["x"] | g.S.at["obs"]
kept = merged.filter(sel)
dropped = merged.filter(~sel)
assert kept["x"] == 1.0
try:
    dropped["x"]
except g.ChoiceMapNoValueAtAddress:
    pass
assert dropped["a"] == 0.5

# -- vmapped models: Indexed lanes ---------------------------------------
# Choices made under `vmap`/`scan` combinators get a leading lane axis;
# indexing with an integer first selects the lane.
@g.gen
def kernel(mu):
    return g.normal(mu, 1.0) @ "z"


vm = kernel.vmap(in_axes=0)
tr = vm.simulate(jax.random.key(0), (jnp.arange(4.0),))
lanes = tr.get_choices()
assert lanes[2, "z"].shape == ()          # lane 2's choice
assert lanes[:, "z"].shape == (4,)        # all lanes, stacked
print(pformat(lanes))

# Writing lane-targeted constraints uses the same syntax:
constraint = g.C[2, "z"].set(10.0)       # only lane 2 is constrained
tr2, w = vm.generate(jax.random.key(1), constraint, (jnp.arange(4.0),))
assert tr2.get_choices()[2, "z"] == 10.0

# -- masks: static-shape optionality -------------------------------------
# Under jit everything has a fixed shape, so "maybe a value" is a Mask
# (value + boolean flag), not a missing entry. Branch-dependent choices
# (switch), masked iteration, and lane-partial constraints all produce
# masks; `unmask` asserts the flag and unwraps.
m = g.Mask(jnp.asarray(3.0), jnp.asarray(True))
assert m.unmask() == 3.0

# -- choice maps in inference --------------------------------------------
# Observations are just choice maps handed to `generate`/`Target`:
@g.gen
def model():
    x = g.normal(0.0, 1.0) @ "x"
    g.normal(x, 0.1) @ "y"
    return x


obs = g.C["y"].set(0.8)
tr3, w3 = model.generate(jax.random.key(2), obs, ())
# ...and posterior samples come back out as choice maps:
posterior_x = tr3.get_choices().filter(~g.S.at["y"])
print("posterior draw:", float(posterior_x["x"]), " weight:", float(w3))
print("ok")
