"""Cookbook 11 — Block-Gibbs on a Dirichlet mixture model.

A realistic end-to-end application (parity with the reference
cookbook's `7_application_dirichlet_mixture_model.ipynb`, reference
`docs/cookbook/inactive/update/`): cluster N points on the real line
with a K-component Gaussian mixture — Dirichlet prior on the weights,
Gaussian prior on each cluster mean, a categorical assignment per
point — and infer by block Gibbs sampling, where each block's exact
conditional draw is written into the trace with a whole-lane `Update`.

What this exercises: `dirichlet`, the `repeat` combinator (N iid
assignment/observation pairs as one vectorized site), whole-lane
Indexed constraints (`C["pts", jnp.arange(N), "z"].set(...)` edits
every lane in one O(N) update), and the GFI edit loop as the engine of
a Gibbs sampler — the conditionals are computed OUTSIDE the model (in
plain JAX) and the trace is the single source of truth for the state.
The whole sweep jits; on an accelerator the N and K axes are ordinary vector
lanes.
"""

import jax
import jax.numpy as jnp
import numpy as np

import genjax_xla as g

key = jax.random.key(0)

N, K = 240, 3
SIGMA = 0.6          # known observation noise
TAU = 10.0           # prior std of cluster means
ALPHA = jnp.ones(K)  # symmetric Dirichlet prior on weights


@g.gen
def point(weights, mus):
    zi = g.categorical(jnp.log(weights)) @ "z"
    _ = g.normal(mus[zi], SIGMA) @ "x"


@g.gen
def dpmm():
    weights = g.dirichlet(ALPHA) @ "weights"
    mus = g.mv_normal_diag(jnp.zeros(K), TAU * jnp.ones(K)) @ "mus"
    _ = point.repeat(n=N)(weights, mus) @ "pts"


# -- synthetic data ------------------------------------------------------
TRUE_MUS = np.array([-4.0, 0.0, 5.0])
TRUE_W = np.array([0.5, 0.3, 0.2])
rng = np.random.default_rng(7)
true_z = rng.choice(K, size=N, p=TRUE_W)
xs = jnp.asarray(TRUE_MUS[true_z] + SIGMA * rng.standard_normal(N))

# -- initialize a trace consistent with the observations -----------------
obs = g.C["pts", jnp.arange(N), "x"].set(xs)
tr, _ = dpmm.generate(key, obs, ())

IDX = jnp.arange(N)
ONEHOT = jnp.arange(K)


def gibbs_sweep(tr, key):
    k_z, k_mu, k_w = jax.random.split(key, 3)
    chm = tr.get_choices()
    weights = chm["weights"]
    mus = chm["mus"]

    # Block 1: assignments | weights, means — exact categorical
    # posterior per point, all N lanes at once.
    logits = jnp.log(weights)[None, :] + jax.scipy.stats.norm.logpdf(
        xs[:, None], mus[None, :], SIGMA
    )
    z_new = jax.random.categorical(k_z, logits, axis=-1)
    tr, _, _, _ = tr.update(
        k_z, g.C["pts", IDX, "z"].set(z_new)
    )

    # Block 2: means | assignments — conjugate normal per cluster.
    onehot = (z_new[:, None] == ONEHOT[None, :]).astype(jnp.float32)
    counts = onehot.sum(0)
    sums = (onehot * xs[:, None]).sum(0)
    post_prec = 1.0 / TAU**2 + counts / SIGMA**2
    post_var = 1.0 / post_prec
    post_mean = post_var * (sums / SIGMA**2)
    mus_new = post_mean + jnp.sqrt(post_var) * jax.random.normal(
        k_mu, (K,)
    )
    tr, _, _, _ = tr.update(k_mu, g.C["mus"].set(mus_new))

    # Block 3: weights | assignments — Dirichlet posterior.
    w_new = jax.random.dirichlet(k_w, ALPHA + counts)
    tr, _, _, _ = tr.update(k_w, g.C["weights"].set(w_new))
    return tr


sweep = jax.jit(gibbs_sweep)
for i in range(60):
    tr = sweep(tr, jax.random.fold_in(key, i))

chm = tr.get_choices()
mus_hat = np.sort(np.asarray(chm["mus"]))
w_hat = np.asarray(chm["weights"])
order = np.argsort(np.asarray(chm["mus"]))

# Cluster means recovered (label-permutation-invariant).
assert np.abs(mus_hat - TRUE_MUS).max() < 0.3, mus_hat
# Weights recovered.
assert np.abs(w_hat[order] - TRUE_W).max() < 0.12, w_hat[order]
# Assignment accuracy after aligning labels.
z_hat = np.asarray(chm["pts", :, "z"])
relabel = np.empty(K, int)
relabel[order] = np.arange(K)
acc = float((relabel[z_hat] == true_z).mean())
assert acc > 0.93, acc
# The trace stays internally consistent: its score re-assesses.
score, _ = dpmm.assess(chm, ())
assert np.isfinite(float(score))

print("cookbook 11 ok:", mus_hat, w_hat[order], f"acc={acc:.3f}")
