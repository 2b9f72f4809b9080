"""Data-annealed SMC: logZ vs exact conjugate marginals when assimilating
observations one at a time, with and without rejuvenation."""

import jax
import jax.numpy as jnp
import numpy as np

import genjax_xla as g
from genjax_xla.inference import Target
from genjax_xla.inference.data_smc import data_annealed_smc

KEY = jax.random.key(314159)

OBS = [True, True, False, True, True]


@g.gen
def coins():
    p = g.beta(2.0, 2.0) @ "p"
    for i in range(len(OBS)):
        _ = g.flip(p) @ f"v{i}"


def exact_logz():
    # P(obs) = B(2 + h, 2 + t) / B(2, 2), h heads, t tails.
    from scipy.special import betaln

    h = sum(OBS)
    t = len(OBS) - h
    return betaln(2 + h, 2 + t) - betaln(2, 2)


class TestDataSMC:
    def test_logz_matches_exact(self):
        schedule = [g.C[f"v{i}"].set(OBS[i]) for i in range(len(OBS))]
        run = data_annealed_smc(coins, (), schedule, n_particles=4096)
        result = jax.jit(run)(KEY)
        np.testing.assert_allclose(
            float(result.log_z), exact_logz(), atol=0.05
        )
        assert result.ess_history.shape == (len(OBS),)

    def test_with_rejuvenation(self):
        schedule = [g.C[f"v{i}"].set(OBS[i]) for i in range(len(OBS))]
        run = data_annealed_smc(
            coins, (), schedule, n_particles=2048,
            make_request=lambda: g.Regenerate(g.S.at["p"]),
            n_moves=2,
        )
        result = jax.jit(run)(KEY)
        np.testing.assert_allclose(
            float(result.log_z), exact_logz(), atol=0.05
        )
        # Posterior mean of p: (2+h)/(4+n)
        w = jax.nn.softmax(result.log_weights)
        ps = result.traces.get_choices()["p"]
        want = (2 + sum(OBS)) / (4 + len(OBS))
        assert abs(float((w * ps).sum()) - want) < 0.03
        assert float(result.accept_rate.mean()) > 0.1

    def test_grouped_schedule(self):
        """Constraint groups of unequal sizes."""
        schedule = [
            g.C["v0"].set(OBS[0]) | g.C["v1"].set(OBS[1]),
            g.C["v2"].set(OBS[2]),
            g.C["v3"].set(OBS[3]) | g.C["v4"].set(OBS[4]),
        ]
        run = data_annealed_smc(coins, (), schedule, n_particles=4096)
        result = jax.jit(run)(KEY)
        np.testing.assert_allclose(
            float(result.log_z), exact_logz(), atol=0.05
        )
