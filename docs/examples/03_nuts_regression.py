"""Hierarchical linear regression with NUTS (cross-chain warmup
adaptation) + convergence diagnostics."""

import jax
import jax.numpy as jnp
import numpy as np

import genjax_xla as g
from genjax_xla.inference import Target, run_nuts, split_rhat, summarize


xs = jnp.linspace(-1.0, 1.0, 30)
ys_obs = 2.0 * xs - 0.5


@g.gen
def regression(xs):
    slope = g.normal(0.0, 2.0) @ "slope"
    icept = g.normal(0.0, 2.0) @ "icept"
    log_sigma = g.normal(-2.0, 0.5) @ "log_sigma"
    _ = g.mv_normal_diag(
        slope * xs + icept, jnp.exp(log_sigma) * jnp.ones_like(xs)
    ) @ "ys"


if __name__ == "__main__":
    target = Target(regression, (xs,), g.C["ys"].set(ys_obs))
    chms, infos = jax.jit(
        lambda k: run_nuts(target, k, n_chains=4, num_warmup=400,
                           num_samples=600, max_depth=6)
    )(jax.random.key(0))
    slopes = np.asarray(chms["slope"])
    print("slope mean:", slopes.mean(), " (true 2.0)")
    print("slope R-hat:", float(split_rhat(jnp.asarray(slopes))))
    print("mean accept:", float(np.asarray(infos.accept_prob).mean()))
