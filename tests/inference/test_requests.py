"""Edit-request invariant tests: forward/backward weight antisymmetry,
weight = Δ target density, and statistical convergence of MH chains driven
by Regenerate / Rejuvenate / HMC edits.

Mirrors ``/root/reference/tests/inference/test_requests.py`` (antisymmetry
:59-92, Δ-density :94-118, MH convergence :120-193, HMC :238-270).
"""

import jax
import jax.numpy as jnp
import numpy as np

import genjax_xla as g
from genjax_xla.inference import HMC, Rejuvenate, chain, mh

KEY = jax.random.key(314159)


@g.gen
def conjugate_normal(obs_std):
    # mu ~ N(0, 1); y ~ N(mu, obs_std). Posterior of mu given y:
    # N(y/(1+obs_std^2), sqrt(obs_std^2/(1+obs_std^2))).
    mu = g.normal(0.0, 1.0) @ "mu"
    y = g.normal(mu, obs_std) @ "y"
    return y


def posterior_params(y, obs_std):
    var = obs_std**2 / (1 + obs_std**2)
    return y / (1 + obs_std**2), np.sqrt(var)


class TestWeightIdentities:
    def test_regenerate_weight_is_delta_density(self):
        tr, _ = conjugate_normal.generate(KEY, g.C["y"].set(1.0), (0.5,))
        new_tr, w, _, _ = tr.edit(
            jax.random.key(1), g.Regenerate(g.S.at["mu"])
        )
        # w = new joint - old joint - (new prior - old prior)
        #   = Δ likelihood of y.
        mu0 = tr.get_choices()["mu"]
        mu1 = new_tr.get_choices()["mu"]
        import jax.scipy.stats as jss

        want = jss.norm.logpdf(1.0, mu1, 0.5) - jss.norm.logpdf(1.0, mu0, 0.5)
        assert jnp.allclose(w, want, atol=1e-5)

    def test_hmc_preserves_hamiltonian_small_eps(self):
        """With a tiny step size the leapfrog is near-exact, so the alpha
        ratio should be ~0 (log scale)."""
        tr, _ = conjugate_normal.generate(KEY, g.C["y"].set(1.0), (0.5,))
        _, alpha, _, _ = tr.edit(
            jax.random.key(1), HMC(g.S.at["mu"], 1e-4, 10)
        )
        assert jnp.abs(alpha) < 1e-4

    def test_rejuvenate_weight_antisymmetry(self):
        """Symmetric proposal: fwd weight of a move + fwd weight of the
        exact reverse move cancel."""

        @g.gen
        def drift(old_choices):
            mu = g.normal(old_choices["mu"], 0.25) @ "mu"
            return mu

        tr, _ = conjugate_normal.generate(KEY, g.C["y"].set(1.0), (0.5,))
        new_tr, w_fwd, _, _bwd = tr.edit(
            jax.random.key(1), Rejuvenate(drift)
        )
        # Reverse: constrain the proposal to give back the old value.
        old_mu = tr.get_choices()["mu"]
        back_tr, w_bwd, _, _ = new_tr.update(
            jax.random.key(2), g.C["mu"].set(old_mu)
        )
        # Update weight + drift density ratio reproduces -w_fwd.
        import jax.scipy.stats as jss

        new_mu = new_tr.get_choices()["mu"]
        corr = jss.norm.logpdf(new_mu, old_mu, 0.25) - jss.norm.logpdf(
            old_mu, new_mu, 0.25
        )
        assert jnp.allclose(w_fwd + w_bwd + corr, 0.0, atol=1e-5)
        assert jnp.allclose(back_tr.get_score(), tr.get_score(), atol=1e-5)


class TestMHConvergence:
    def _run_chain(self, kernel_request_fn, n_steps=400):
        obs_std = 0.5
        tr, _ = conjugate_normal.generate(KEY, g.C["y"].set(1.0), (obs_std,))

        def kernel(key, trace):
            return mh(key, trace, kernel_request_fn())

        runner = chain(kernel)
        _, mus = jax.jit(
            lambda k, t: runner(
                k, t, n_steps=n_steps,
                collect=lambda tr: tr.get_choices()["mu"],
            )
        )(jax.random.key(7), tr)
        return np.asarray(mus)

    def test_regenerate_mh_posterior_mean(self):
        mus = self._run_chain(lambda: g.Regenerate(g.S.at["mu"]), 800)
        mean, _sd = posterior_params(1.0, 0.5)
        assert abs(mus[200:].mean() - mean) < 5e-2

    def test_rejuvenate_mh_posterior(self):
        @g.gen
        def drift(old_choices):
            mu = g.normal(old_choices["mu"], 0.5) @ "mu"
            return mu

        mus = self._run_chain(lambda: Rejuvenate(drift), 800)
        mean, sd = posterior_params(1.0, 0.5)
        assert abs(mus[200:].mean() - mean) < 5e-2
        assert abs(mus[200:].std() - sd) < 5e-2

    def test_hmc_mh_posterior(self):
        mus = self._run_chain(lambda: HMC(g.S.at["mu"], 0.1, 10), 400)
        mean, sd = posterior_params(1.0, 0.5)
        assert abs(mus[100:].mean() - mean) < 5e-2
        assert abs(mus[100:].std() - sd) < 5e-2

    def test_hmc_on_scan_model(self):
        """HMC over every latent of a scanned state-space model."""

        @g.gen
        def step(carry, _):
            x = g.normal(carry, 0.5) @ "x"
            y = g.normal(x, 0.3) @ "y"
            return x, x

        sc = step.scan(n=3)
        obs = g.ChoiceMap.empty()
        for i in range(3):
            obs = obs | g.C[i, "y"].set(1.0)
        tr, _ = sc.generate(KEY, obs, (0.0, None))
        sel = g.S.at[0, "x"] | g.S.at[1, "x"] | g.S.at[2, "x"]

        def kernel(key, trace):
            return mh(key, trace, HMC(sel, 0.05, 5))

        runner = chain(kernel)
        final, accepts = jax.jit(
            lambda k, t: runner(
                k, t, n_steps=100, collect=lambda tr: tr.get_score()
            )
        )(jax.random.key(3), tr)
        assert bool(jnp.isfinite(final.get_score()))
        # chain must have moved:
        assert float(jnp.std(accepts)) > 0.0


class TestMultiChain:
    def test_multi_chain_runner(self):
        from genjax_xla.inference import multi_chain

        obs_std = 0.5

        def init_trace(key):
            tr, _ = conjugate_normal.generate(
                key, g.C["y"].set(1.0), (obs_std,)
            )
            return tr

        def kernel(key, trace):
            return mh(key, trace, g.Regenerate(g.S.at["mu"]))

        runner = multi_chain(kernel, n_chains=4)
        final, mus = jax.jit(
            lambda k: runner(
                k, init_trace, n_steps=400,
                collect=lambda tr: tr.get_choices()["mu"],
            )
        )(jax.random.key(2))
        assert mus.shape == (4, 400)
        mean, _ = posterior_params(1.0, obs_std)
        assert abs(float(mus[:, 100:].mean()) - mean) < 5e-2
        # chains differ:
        assert float(np.std(np.asarray(mus[:, -1]))) > 0.0
