"""Cookbook 1 — The Generative Function Interface, by hand.

Every model in genjax_xla is a *generative function*: a probabilistic
program with a small abstract interface (the GFI). Inference algorithms
are written once against this interface and work for any model. This
walkthrough exercises each method on one tiny model and checks the
weight identities that make SMC/MCMC/VI correct.

Parity: the reference cookbook's `generative_function_interface.ipynb`
(reference `docs/cookbook/active/`), re-derived for this framework. The
GFI itself is defined in `genjax_xla/gfi/gfn.py` (reference
`generative_function.py`).

Conventions (gfi/concepts.py):
- `score`  = log P(all choices; args)  — a density, not a bound.
- `weight` = the importance/edit weight; every method below documents
  its exact identity. Getting these right is what makes logZ estimates
  unbiased and MH acceptance ratios exact.
"""

import jax
import jax.numpy as jnp
import jax.scipy.stats as jss

import genjax_xla as g

key = jax.random.key(0)


@g.gen
def model(mu):
    x = g.normal(mu, 1.0) @ "x"      # latent
    y = g.normal(x, 0.5) @ "y"       # observed later
    return x + y


# -- simulate: sample a full trace from the prior ------------------------
tr = model.simulate(key, (0.0,))
x, y = tr.get_choices()["x"], tr.get_choices()["y"]
print("simulate:   x =", float(x), " y =", float(y))

# The score is the joint log-density of ALL sampled choices:
want = jss.norm.logpdf(x, 0.0, 1.0) + jss.norm.logpdf(y, x, 0.5)
assert jnp.allclose(tr.get_score(), want), "score = log P(x, y)"

# -- assess: score a COMPLETE choice map (no randomness) -----------------
chm = g.C["x"].set(1.0) | g.C["y"].set(0.5)
score, retval = model.assess(chm, (0.0,))
assert jnp.allclose(
    score,
    jss.norm.logpdf(1.0, 0.0, 1.0) + jss.norm.logpdf(0.5, 1.0, 0.5),
)
assert jnp.allclose(retval, 1.5)
print("assess:     log P(x=1, y=0.5) =", float(score))

# -- generate (importance): constrain some choices, sample the rest ------
# weight = log P(all choices) - log q(sampled | constrained).
# For @gen models q is "ancestral sampling of the unconstrained sites",
# so the weight telescopes to the density of the CONSTRAINED sites under
# their local kernels — here just log P(y = 0.3 | x).
obs = g.C["y"].set(0.3)
tr_c, w = model.generate(key, obs, (0.0,))
x_c = tr_c.get_choices()["x"]
assert jnp.allclose(w, jss.norm.logpdf(0.3, x_c, 0.5))
print("generate:   weight = log P(y|x) =", float(w))
# Averaging exp(weight) over many keys estimates the marginal P(y=0.3):
# this is exactly importance sampling — `inference.smc.Importance` wraps
# this method.

# -- update (edit): move a trace to new constraints ----------------------
# weight = log P(new choices) - log P(old choices) + (proposal terms for
# any freshly sampled sites; none here). The discard holds the replaced
# values, so the edit is reversible (SMCP3 identities, tested in
# tests/lang/test_static_edit.py).
new_tr, w_up, _retdiff, discard = model.update(
    key, tr, g.C["x"].set(2.0), g.Diff.no_change((0.0,))
)
assert jnp.allclose(
    w_up, new_tr.get_score() - tr.get_score()
), "pure-update weight identity"
assert jnp.allclose(discard["x"], x), "discard holds the old value"
print("update:     w =", float(w_up), " (= new_score - old_score)")

# -- regenerate: resample selected sites from their priors ---------------
# This is the MH-within-Gibbs building block: weight = the (log) MH
# ratio for the prior-proposal kernel. (Fresh key: edits derive per-site
# randomness from the key you pass, deterministically.)
re_tr, w_re, _rd, _bwd = tr.edit(jax.random.key(42),
                                 g.Regenerate(g.S.at["x"]))
assert re_tr.get_choices()["y"] == y, "unselected sites keep values"
print("regenerate: new x =", float(re_tr.get_choices()["x"]),
      " MH log-ratio =", float(w_re))

# -- project: the weight of forgetting selected choices ------------------
w_proj = tr.project(key, g.S.at["y"])
assert jnp.allclose(w_proj, jss.norm.logpdf(y, x, 0.5))
print("project:    log P(y | rest) =", float(w_proj))

# -- everything composes under jit/vmap ----------------------------------
# The GFI methods are pure functions of (key, pytrees): they jit and
# vmap like any JAX code. 1000 importance samples in one compiled call:
keys = jax.random.split(key, 8192)
_, ws = jax.jit(jax.vmap(lambda k: model.generate(k, obs, (0.0,))))(keys)
logz = jax.scipy.special.logsumexp(ws) - jnp.log(len(keys))
# Exact marginal: y ~ N(0, sqrt(1 + 0.25)) under mu=0.
exact = jss.norm.logpdf(0.3, 0.0, jnp.sqrt(1.25))
assert jnp.abs(logz - exact) < 1e-1, (logz, exact)
print("vmap'd IS:  logZ ≈", float(logz), " (exact:", float(exact), ")")
print("ok")
