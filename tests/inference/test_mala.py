"""MALA edit request: exact acceptance-ratio identity against a
hand-computed Langevin proposal density, small-eps behavior, and MH
posterior convergence (mirrors the HMC tests in test_requests.py)."""

import jax
import jax.numpy as jnp
import jax.scipy.stats as jss
import numpy as np

import genjax_xla as g
from genjax_xla.inference import MALA, chain, mh

KEY = jax.random.key(314159)


@g.gen
def conjugate_normal(obs_std):
    mu = g.normal(0.0, 1.0) @ "mu"
    y = g.normal(mu, obs_std) @ "y"
    return y


def posterior_params(y, obs_std):
    var = obs_std**2 / (1 + obs_std**2)
    return y / (1 + obs_std**2), np.sqrt(var)


def logp(mu, y=1.0, obs_std=0.5):
    return jss.norm.logpdf(mu, 0.0, 1.0) + jss.norm.logpdf(
        y, mu, obs_std
    )


def grad_logp(mu, y=1.0, obs_std=0.5):
    return jax.grad(logp)(mu, y, obs_std)


class TestAlphaIdentity:
    def test_alpha_matches_hand_computed_ratio(self):
        eps = 0.3
        tr, _ = conjugate_normal.generate(KEY, g.C["y"].set(1.0), (0.5,))
        new_tr, alpha, _, bwd = tr.edit(
            jax.random.key(3), MALA(g.S.at["mu"], eps)
        )
        mu0 = tr.get_choices()["mu"]
        mu1 = new_tr.get_choices()["mu"]
        half = 0.5 * eps * eps

        def logq(y_, x_):
            return jss.norm.logpdf(y_, x_ + half * grad_logp(x_), eps)

        want = (
            logp(mu1) - logp(mu0) + logq(mu0, mu1) - logq(mu1, mu0)
        )
        assert jnp.allclose(alpha, want, atol=1e-5)
        assert isinstance(bwd, MALA)

    def test_small_eps_alpha_near_zero(self):
        tr, _ = conjugate_normal.generate(KEY, g.C["y"].set(1.0), (0.5,))
        _, alpha, _, _ = tr.edit(
            jax.random.key(1), MALA(g.S.at["mu"], 1e-3)
        )
        assert jnp.abs(alpha) < 1e-4

    def test_proposal_moves_toward_mode_at_zero_noise(self):
        """The drift term alone pushes the chain up the gradient: from
        a point far below the posterior mode, the proposal mean must be
        strictly closer to the mode."""
        tr, _ = conjugate_normal.generate(
            jax.random.key(8),
            g.C["y"].set(1.0) | g.C["mu"].set(-3.0), (0.5,)
        )
        mode, _ = posterior_params(1.0, 0.5)
        eps = 0.2
        new_tr, _, _, _ = tr.edit(jax.random.key(5), MALA(g.S.at["mu"], eps))
        mu1 = float(new_tr.get_choices()["mu"])
        drift = -3.0 + 0.5 * eps * eps * float(grad_logp(-3.0))
        # realized proposal = drift + eps*xi with |xi| a few at most
        assert abs(mu1 - drift) < 5 * eps
        assert abs(drift - mode) < abs(-3.0 - mode)


class TestMALAConvergence:
    def test_mh_posterior_mean_and_std(self):
        obs_std = 0.5
        tr, _ = conjugate_normal.generate(
            KEY, g.C["y"].set(1.0), (obs_std,)
        )

        def kernel(key, trace):
            return mh(key, trace, MALA(g.S.at["mu"], 0.45))

        runner = chain(kernel)
        _, (mus, accs) = jax.jit(
            lambda k, t: runner(
                k, t, n_steps=1500,
                collect=lambda tr_: (tr_.get_choices()["mu"], 0),
            )
        )(jax.random.key(7), tr)
        mus = np.asarray(mus)[300:]
        mean, sd = posterior_params(1.0, obs_std)
        assert abs(mus.mean() - mean) < 5e-2
        assert abs(mus.std() - sd) < 5e-2

    def test_multi_site_selection(self):
        """MALA over two latent sites at once (pytree positions)."""

        @g.gen
        def two_site():
            a = g.normal(0.0, 1.0) @ "a"
            b = g.normal(a, 1.0) @ "b"
            y = g.normal(b, 0.5) @ "y"
            return y

        tr, _ = two_site.generate(KEY, g.C["y"].set(2.0), ())

        def kernel(key, trace):
            return mh(
                key, trace, MALA(g.S.at["a"] | g.S.at["b"], 0.35)
            )

        runner = chain(kernel)
        _, abs_ = jax.jit(
            lambda k, t: runner(
                k, t, n_steps=4000,
                collect=lambda tr_: (
                    tr_.get_choices()["a"], tr_.get_choices()["b"]
                ),
            )
        )(jax.random.key(9), tr)
        a_s, b_s = (np.asarray(v)[800:] for v in abs_)
        # Exact posterior: precision algebra on the Gaussian chain
        # a~N(0,1), b~N(a,1), y=2 obs with std 0.5.
        # p(a,b|y) Gaussian; marginal means: solve the linear system.
        # joint precision: Laa=2 (prior+b), Lbb=1+4, Lab=-1; h_b = 4*y.
        P = np.array([[2.0, -1.0], [-1.0, 5.0]])
        h = np.array([0.0, 8.0])
        mean = np.linalg.solve(P, h)
        assert abs(a_s.mean() - mean[0]) < 1e-1
        assert abs(b_s.mean() - mean[1]) < 1e-1
