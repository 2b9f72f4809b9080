"""SMC samplers: waste-free tempering and data annealing."""

import jax
import jax.numpy as jnp

import genjax_xla as g
from genjax_xla.inference import (
    HMC,
    Target,
    data_annealed_smc,
    waste_free_tempered_smc,
)

OBS = [True, True, False, True, True]


@g.gen
def coins():
    p = g.beta(2.0, 2.0) @ "p"
    for i in range(len(OBS)):
        _ = g.flip(p) @ f"v{i}"


@g.gen
def gauss(s):
    mu = g.normal(0.0, 1.0) @ "mu"
    _ = g.normal(mu, s) @ "y"


if __name__ == "__main__":
    # Waste-free tempered SMC with HMC rejuvenation: every MCMC state
    # joins the ensemble.
    target = Target(gauss, (0.5,), g.C["y"].set(1.0))
    run = waste_free_tempered_smc(
        target, n_resampled=128, n_moves_per_particle=8, n_temps=15,
        make_request=lambda: HMC(g.S.at["mu"], 0.25, 5),
    )
    r = jax.jit(run)(jax.random.key(0))
    print("waste-free logZ:", float(r.log_z),
          "(exact -1.228); ensemble:", r.log_weights.shape[0])

    # Data-annealed SMC: assimilate coin flips one at a time.
    schedule = [g.C[f"v{i}"].set(OBS[i]) for i in range(len(OBS))]
    run2 = data_annealed_smc(
        coins, (), schedule, n_particles=2048,
        make_request=lambda: g.Regenerate(g.S.at["p"]), n_moves=1,
    )
    r2 = jax.jit(run2)(jax.random.key(1))
    w = jax.nn.softmax(r2.log_weights)
    ps = r2.traces.get_choices()["p"]
    print("data-SMC posterior mean p:", float((w * ps).sum()),
          "(exact 0.667); ESS history:",
          [f"{e:.0f}" for e in r2.ess_history])
