"""Constrained-support NUTS with automatic transforms.

``run_nuts(transforms="auto")`` reads the support metadata of each
distribution in the model (``"positive"``, ``(low, high)``,
``"simplex"``) and runs NUTS in unconstrained space with the
change-of-variables correction — no manual log-/logit-reparameterization
needed. Works for latents nested in sub-``@gen`` functions and inside
``Scan`` (the step index stays transparent in the transform path).
"""

import jax
import jax.numpy as jnp
import numpy as np

import genjax_xla as g
from genjax_xla.inference import Target, run_nuts
from genjax_xla.inference.transforms import infer_transforms

# -- Dirichlet-categorical: a simplex latent -------------------------------

alpha = jnp.array([1.0, 2.0, 3.0])
counts = jnp.array([10.0, 5.0, 5.0])

# The categorical count likelihood as a one-site exact density.
counts_lik = g.exact_density(
    lambda key, p: p,
    lambda v, p: jnp.sum(counts * jnp.log(p)),
    "counts_lik",
)


@g.gen
def dirichlet_model():
    p = g.dirichlet(alpha) @ "p"          # support: "simplex"
    _ = counts_lik(p) @ "obs"


if __name__ == "__main__":
    probe = dirichlet_model.simulate(jax.random.key(0), ())
    print("inferred transforms:", infer_transforms(probe))

    target = Target(dirichlet_model, (), g.C["obs"].set(jnp.zeros(3)))
    chms, _ = jax.jit(
        lambda k: run_nuts(target, k, n_chains=2, num_warmup=300,
                           num_samples=400, max_depth=6,
                           transforms="auto")
    )(jax.random.key(1))

    ps = np.asarray(chms["p"])            # (chains, samples, 3) on Δ²
    post = np.asarray(alpha + counts)
    post = post / post.sum()
    print("posterior mean:", ps.mean(axis=(0, 1)))
    print("exact (conjugate):", post)
    assert np.allclose(ps.sum(axis=-1), 1.0, atol=1e-5)
    assert np.max(np.abs(ps.mean(axis=(0, 1)) - post)) < 0.05

    # -- positive scale inside a Scan --------------------------------------

    T = 4

    @g.gen
    def step(carry, _):
        s = g.half_normal(1.0) @ "s"      # support: "positive", per step
        _ = g.normal(0.0, s + 0.1) @ "y"
        return carry, None

    @g.gen
    def vol_model():
        _ = step.scan(n=T)(0.0, None) @ "chain"

    obs = g.ChoiceMap.empty()
    for t in range(T):
        obs = obs | g.C["chain", t, "y"].set(1.0)

    chms2, _ = jax.jit(
        lambda k: run_nuts(Target(vol_model, (), obs), k, n_chains=2,
                           num_warmup=200, num_samples=200, max_depth=6,
                           transforms="auto")
    )(jax.random.key(2))
    scales = np.stack(
        [np.asarray(chms2["chain", t, "s"]) for t in range(T)]
    )
    print("scan scales min:", scales.min(), "(all positive)")
    assert np.all(scales > 0.0)
