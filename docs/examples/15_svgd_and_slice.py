"""Example 15 — SVGD ensembles and elliptical slice sampling.

Two inference families this framework adds beyond the reference
(`inference/svgd.py`, `inference/requests/ess.py`), on the same
hierarchical model, cross-checked against each other and NUTS:

- **SVGD** fits a deterministic particle ensemble by kernelized Stein
  descent — every update is a dense (N, N) matrix contraction, no
  accept/reject, no step-size adaptation.
- **Elliptical slice sampling** moves Gaussian-prior latents with zero
  tuning — the ellipse is drawn from the model's own prior via the GFI
  (`generate` on the complement), and the likelihood factor is
  `score − trace.project(selection)`.
"""

import jax
import jax.numpy as jnp
import numpy as np

import genjax_xla as g
from genjax_xla.inference import (
    EllipticalSlice,
    Target,
    mh,
    run_nuts,
    run_svgd,
)

key = jax.random.key(15)

# A small Gaussian-prior regression: weights w ~ N(0, I) (conditionally
# Gaussian, so ESS applies exactly), observed through a linear map.
D = 8
X = jax.random.normal(jax.random.fold_in(key, 0), (40, D)) / jnp.sqrt(D)
w_true = jnp.linspace(-1.0, 1.0, D)
y_obs = X @ w_true + 0.1 * jax.random.normal(
    jax.random.fold_in(key, 1), (40,)
)


@g.gen
def blr(X):
    w = g.mv_normal_diag(jnp.zeros(D), jnp.ones(D)) @ "w"
    _ = g.mv_normal_diag(X @ w, 0.1 * jnp.ones(X.shape[0])) @ "y"


target = Target(blr, (X,), g.C["y"].set(y_obs))

# Exact posterior (conjugate): precision I + X^T X / 0.01.
prec = jnp.eye(D) + X.T @ X / 0.01
post_mean = jnp.linalg.solve(prec, X.T @ y_obs / 0.01)

# --- SVGD: one jitted fit, ensemble approximates the posterior. -------
ens = jax.jit(
    lambda k: run_svgd(target, k, n_particles=256, n_steps=400,
                       step_size=0.05)
)(jax.random.fold_in(key, 2))
svgd_mean = np.asarray(ens["w"]).mean(axis=0)
print("SVGD  mean err:", float(np.abs(svgd_mean - post_mean).max()))

# --- Elliptical slice: tuning-free MCMC on the same latents. ----------
req = EllipticalSlice(g.Selection.at["w"])
tr, _ = target.importance(jax.random.fold_in(key, 3), g.ChoiceMap.empty())


def step(tr, k):
    new_tr, _ = mh(k, tr, req)
    return new_tr, new_tr.get_choices()["w"]


_, ws = jax.jit(
    lambda tr: jax.lax.scan(
        step, tr, jax.random.split(jax.random.fold_in(key, 4), 2000)
    )
)(tr)
ess_mean = np.asarray(ws)[500:].mean(axis=0)
print("ESS   mean err:", float(np.abs(ess_mean - post_mean).max()))

# --- NUTS reference on the same target. -------------------------------
chms, _ = jax.jit(
    lambda k: run_nuts(target, k, n_chains=8, num_warmup=100,
                       num_samples=150, max_depth=6)
)(jax.random.fold_in(key, 5))
nuts_mean = np.asarray(chms["w"]).mean(axis=(0, 1))
print("NUTS  mean err:", float(np.abs(nuts_mean - post_mean).max()))

for name, m in [("svgd", svgd_mean), ("ess", ess_mean),
                ("nuts", nuts_mean)]:
    assert np.abs(m - post_mean).max() < 0.15, name
print("all three agree with the exact conjugate posterior")
