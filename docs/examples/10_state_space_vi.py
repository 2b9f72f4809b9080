"""Variational inference with a state-space (lax.scan) guide — reparam
sites inside scan differentiate pathwise through ADEV."""

import jax
import jax.numpy as jnp

import genjax_xla as g
from genjax_xla.inference import Target, marginal, vi

T = 5
obs = jnp.full(T, 2.0)


@g.gen
def ssm(shift):
    @g.gen
    def step(carry, _):
        x = g.normal(carry, 0.5) @ "x"
        _ = g.normal(x, 0.3) @ "y"
        return x, None

    _ = step.scan(n=T)(shift, None) @ "chain"


obs_chm = g.ChoiceMap.empty()
for t in range(T):
    obs_chm = obs_chm | g.C["chain", t, "y"].set(obs[t])


@marginal()
@g.gen
def guide(target):
    (shift,) = target.args

    @g.gen
    def gstep(carry, _):
        x = vi.normal_reparam(carry * 0.0 + shift, 0.4) @ "x"
        return x, None

    _ = gstep.scan(n=T)(shift, None) @ "chain"


if __name__ == "__main__":
    elbo_grad = jax.jit(vi.ELBO(
        guide, lambda shift: Target(ssm, (shift,), obs_chm)
    ))
    shift = 0.0
    for i in range(200):
        (dv,) = elbo_grad(jax.random.key(i), (shift,))
        shift -= 5e-3 * dv
    print("trained guide mean:", shift, "(observations at 2.0)")
