"""Cookbook 12 — The combinator zoo: structured models from small parts.

Covers the reference's `mapping_tutorial.ipynb`, `iterating_computation
.ipynb`, `mixture.ipynb`, and `dimap_combinator.ipynb` (reference
`docs/cookbook/inactive/{inference,expressivity,library_author}/`) in
one tour: every combinator takes a generative function and returns a
generative function, so they nest freely — and every one of them lowers
to a single XLA-friendly primitive (`vmap` → batching, `scan` →
`lax.scan`, `switch`/`mix` → dense branch selection, `dimap` → plain
function composition), which is exactly why deep compositions still
compile to one XLA program.
"""

import jax
import jax.numpy as jnp

import genjax_xla as g

key = jax.random.key(0)


# -- vmap: one kernel, many sites -----------------------------------------
# (reference mapping_tutorial.ipynb)
@g.gen
def measure(mu):
    return g.normal(mu, 0.1) @ "y"


panel = measure.vmap(in_axes=0)           # one address space per lane
mus = jnp.arange(4.0)
tr = jax.jit(panel.simulate)(key, (mus,))
print("lane 2 draw:", float(tr.get_choices()[2, "y"]))
print("all lanes:  ", tr.get_choices()[:, "y"])   # full-slice read

# Scores sum over lanes; constraints address single lanes:
tr2, w = panel.generate(key, g.C[1, "y"].set(1.0), (mus,))
print("lane-1 constraint weight:", float(w))

# `repeat` is vmap over a dummy index — i.i.d. replicas of a model:
reps = measure.repeat(n=3)
print("3 iid draws:", reps.simulate(key, (0.0,)).get_choices()[:, "y"])


# -- scan & the iterate family: sequences --------------------------------
# (reference iterating_computation.ipynb)
@g.gen
def walk_step(prev, _):
    x = g.normal(prev, 1.0) @ "x"
    return x, x


chain = walk_step.scan(n=5)               # (carry, xs) -> (carry, ys)
tr = jax.jit(chain.simulate)(key, (0.0, None))
final, path = tr.get_retval()
print("random-walk path:", path)

# Deterministic-looking variants derived from scan:
# - accumulate: keep every carry (prepends the initial one)
# - iterate:    apply a kernel n times, keep the trajectory
# - reduce:     keep only the final carry
@g.gen
def decay(x):
    return g.normal(0.5 * x, 0.01) @ "x"


print("iterate:", decay.iterate(n=4).simulate(key, (8.0,)).get_retval())
print("final:  ", float(decay.iterate_final(n=4).simulate(key, (8.0,))
                        .get_retval()))


# -- mix: mixture models in one line --------------------------------------
# (reference mixture.ipynb)
@g.gen
def left():
    return g.normal(-2.0, 0.5) @ "v"


@g.gen
def right():
    return g.normal(2.0, 0.5) @ "v"


mixture = g.mix(left, right)
# Args: (mixture logits, branch-0 args, branch-1 args).
tr = jax.jit(mixture.simulate)(key, (jnp.log(jnp.array([0.3, 0.7])),
                                     (), ()))
print("mixture draw:", float(tr.get_retval()))
# The component indicator lives at "mixture_component":
chm = tr.get_choices()
comp = chm["mixture_component"]
comp = comp.unmask() if isinstance(comp, g.Mask) else comp
print("picked component:", int(comp))


# -- dimap / map / contramap: adapters around a kernel ---------------------
# (reference dimap_combinator.ipynb — the "library author" combinator)
# contramap: transform the ARGUMENTS before the kernel sees them.
# map:       transform the RETURN VALUE after.
# dimap:     both. Scores/choices pass through untouched — it is the
#            profunctor around a generative function, and its `edit`
#            pushes argdiffs through the argument mapping incrementally.
@g.gen
def std_normal():
    return g.normal(0.0, 1.0) @ "z"


def to_loc_scale(z):
    return 3.0 + 0.5 * z


scaled = std_normal.map(to_loc_scale)      # non-centered parameterization
tr = jax.jit(scaled.simulate)(key, ())
z = tr.get_choices()["z"]
assert jnp.allclose(tr.get_retval(), 3.0 + 0.5 * z)
print("non-centered draw:", float(tr.get_retval()))

# contramap adapts calling conventions — e.g. make `measure` take a
# config dict instead of a bare float:
cfg_measure = measure.contramap(lambda cfg: (cfg["mu"],))
print("contramapped:",
      float(cfg_measure.simulate(key, ({"mu": 1.5},)).get_retval()))


# -- everything nests ------------------------------------------------------
# A vmapped scan of a mapped kernel — still one jittable program, still
# one address space: (lane, step, "x").
fleet = walk_step.scan(n=4).vmap(in_axes=(0, None))
tr = jax.jit(fleet.simulate)(key, (jnp.zeros(3), None))
print("fleet paths shape:", tr.get_retval()[1].shape)
print("lane 1, step 2:", float(tr.get_choices()[1, 2, "x"]))
