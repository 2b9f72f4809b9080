"""README quickstart: Beta-Bernoulli posterior via K-particle SIR."""

import jax
import jax.numpy as jnp

import genjax_xla as g
from genjax_xla.inference import ImportanceK, Target


@g.gen
def beta_bernoulli(a, b):
    p = g.beta(a, b) @ "p"
    v = g.flip(p) @ "v"
    return v


@jax.jit
def run_inference(obs):
    target = Target(beta_bernoulli, (2.0, 2.0), g.C["v"].set(obs))
    alg = ImportanceK(target, k_particles=50)
    sub_keys = jax.random.split(jax.random.key(314159), 50)
    _, p_chm = jax.vmap(alg.random_weighted, in_axes=(0, None))(
        sub_keys, target
    )
    return jnp.mean(p_chm["p"])


if __name__ == "__main__":
    print("E[p | v=True]  ≈", run_inference(True), " (exact: 0.6)")
    print("E[p | v=False] ≈", run_inference(False), "(exact: 0.4)")
