"""Tempered SMC: anneal from prior to posterior with HMC rejuvenation."""

import jax
import jax.numpy as jnp

import genjax_xla as g
from genjax_xla.inference import HMC, Target, tempered_smc


@g.gen
def model():
    mu = g.normal(0.0, 3.0) @ "mu"
    _ = g.mv_normal_diag(mu * jnp.ones(5), 0.5 * jnp.ones(5)) @ "ys"


if __name__ == "__main__":
    ys = jnp.full(5, 2.0)
    target = Target(model, (), g.C["ys"].set(ys))
    run = tempered_smc(
        target, n_particles=2048, n_temps=20,
        make_request=lambda: HMC(g.S.at["mu"], 0.1, 5), n_moves=1,
    )
    result = jax.jit(run)(jax.random.key(0))
    w = jax.nn.softmax(result.log_weights)
    mus = result.traces.get_choices()["mu"]
    print("logZ:", result.log_z)
    # Exact posterior: precision 1/9 + 5/0.25, mean = 40 / 20.11 ≈ 1.99.
    print("posterior mean:", (w * mus).sum(), "(exact ≈ 1.99)")
    print("rejuvenation accept rates:", result.accept_rate)
