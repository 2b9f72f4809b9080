"""Variational inference with ADEV gradient estimators: train a guide by
ELBO gradient descent."""

import jax

import genjax_xla as g
from genjax_xla.inference import Target, marginal, vi


@g.gen
def model(v):
    mu = g.normal(0.0, 10.0) @ "mu"
    _ = g.normal(mu, 0.1) @ "v"


@marginal()
@g.gen
def guide(target):
    (v,) = target.args
    _ = vi.normal_reparam(v, 0.1) @ "mu"


if __name__ == "__main__":
    elbo_grad = jax.jit(vi.ELBO(
        guide, lambda v: Target(model, (v,), g.C["v"].set(3.0))
    ))
    v = 0.1
    for step in range(200):
        (dv,) = elbo_grad(jax.random.key(step), (v,))
        v -= 1e-3 * dv
    print("learned v:", v, "(posterior mean ≈ 3.0)")
