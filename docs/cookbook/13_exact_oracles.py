"""Cookbook 13 — Testing approximate inference against exact oracles.

A recurring workflow in this framework's own test suite, shown end to
end: when a model is small enough to solve exactly, solve it exactly and
use the result as the ORACLE for whatever approximate algorithm you
actually care about. Three oracles ship in the library:

1. `enumerate_posterior` — ANY finite discrete model: one vmapped
   `assess` over the full support grid (`inference/enumerative.py`).
2. `DiscreteHMM` forward-filter backward-sample — exact state-space
   posteriors and data marginals (`lang/distributions/discrete_hmm.py`).
3. Conjugate closed forms — Gaussian/beta families by hand.

Here: a burglary-style boolean network, solved exactly, then attacked
with self-normalized importance sampling AND Metropolis–Hastings, each
validated against the enumerated truth.
"""

import jax
import jax.numpy as jnp
import numpy as np

import genjax_xla as g
from genjax_xla.gfi.requests import Regenerate
from genjax_xla.inference import (
    ImportanceK,
    Target,
    enumerate_posterior,
    mh,
)

key = jax.random.key(13)


# --- The model: a tiny diagnostic network. ---------------------------------
@g.gen
def alarm_net():
    burglary = g.flip(0.01) @ "burglary"
    quake = g.flip(0.02) @ "quake"
    p_alarm = jnp.where(
        burglary & quake, 0.95,
        jnp.where(burglary, 0.94, jnp.where(quake, 0.29, 0.001)),
    )
    alarm = g.flip(p_alarm) @ "alarm"
    _ = g.flip(jnp.where(alarm, 0.9, 0.05)) @ "john_calls"
    _ = g.flip(jnp.where(alarm, 0.7, 0.01)) @ "mary_calls"


observed = g.C["john_calls"].set(True) | g.C["mary_calls"].set(True)
target = Target(alarm_net, (), observed)

# --- 1. The exact answer: 8 latent states, one vmapped assess. -------------
exact = enumerate_posterior(target)
sup_b, marg_b = exact.site_marginal("burglary")
p_burglary = float(marg_b[np.asarray(sup_b).tolist().index(True)])
print(f"exact   P(burglary | both call) = {p_burglary:.4f}")
print(f"exact   log P(both call)        = {float(exact.log_marginal):.4f}")
# (With the textbook's 0.001/0.002 priors this is the classic ~0.284;
# the 10x priors here keep the prior-proposal MH below well-mixed.)
assert 0.5 < p_burglary < 0.6

# --- 2. Importance sampling, validated against the oracle. -----------------
alg = ImportanceK(target, k_particles=4096)
col = jax.jit(alg.run_smc)(key)
lz_est = float(col.get_log_marginal_likelihood_estimate())
print(f"SIR     log-evidence estimate   = {lz_est:.4f}")
assert abs(lz_est - float(exact.log_marginal)) < 0.1

# --- 3. MH over the latents, validated against the oracle. -----------------
# Prior-proposal Regenerate flips 'burglary' only ~1% of proposals, so
# one chain mixes slowly — run 32 vmapped chains (the usual accelerator answer).
latents = (
    g.Selection.at["burglary"] | g.Selection.at["quake"]
    | g.Selection.at["alarm"]
)
req = Regenerate(latents)


def one_chain(c):
    ck = jax.random.fold_in(jax.random.fold_in(key, 1), c)
    tr, _ = target.importance(ck, g.ChoiceMap.empty())

    def step(tr, k):
        new_tr, _ = mh(k, tr, req)
        return new_tr, new_tr.get_choices()["burglary"]

    _, draws = jax.lax.scan(step, tr, jax.random.split(ck, 3000))
    return draws


draws = jax.jit(jax.vmap(one_chain))(jnp.arange(32))
mh_est = float(np.asarray(draws)[:, 500:].mean())
print(f"MH      P(burglary | both call) = {mh_est:.4f}")
assert abs(mh_est - p_burglary) < 0.05

print("both approximations agree with the enumerated exact posterior")
