"""PMMH vs the exact grid posterior: the Kalman filter gives the exact
marginal likelihood of a 1-D LGSSM at any parameter value, so the true
p(a | y) is computable by quadrature — the PMMH chain (whose likelihood
is a noisy 512-particle bootstrap estimate) must reproduce it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from genjax_xla.inference.pmmh import gaussian_walk_proposal, pmmh
from genjax_xla.inference.pf import particle_filter
from genjax_xla.models.ssm import (
    lgssm_grid_posterior,
    simulate_lgssm_data,
)

A_TRUE, Q, R, T = 0.7, 0.4, 0.4, 60
KEY = jax.random.key(314159)


YS = simulate_lgssm_data(jax.random.key(11), A_TRUE, Q, R, T)[1]
N_PART = 512


def _log_marginal_est(key, a):
    """Bootstrap-PF logZ for transition coefficient ``a`` (traced)."""

    def init2(k):
        x = jnp.sqrt(Q) * jax.random.normal(k, (N_PART,))
        lw = jax.scipy.stats.norm.logpdf(YS[0], x, jnp.sqrt(R))
        return x, lw

    def step(k, xs, y):
        xs = a * xs + jnp.sqrt(Q) * jax.random.normal(k, xs.shape)
        lw = jax.scipy.stats.norm.logpdf(y, xs, jnp.sqrt(R))
        return xs, lw

    pf = particle_filter(init2, step, N_PART, batched=True)
    final, _ = pf(key, YS[1:])
    return final.log_z


def _log_prior(a):
    # Uniform(-1, 1) on the stable region.
    return jnp.where(jnp.abs(a) < 1.0, 0.0, -jnp.inf)


def _exact_grid_posterior():
    mean, std, _ = lgssm_grid_posterior(
        YS, Q, R, jnp.linspace(-0.95, 0.95, 191)
    )
    return float(mean), float(std)


class TestPMMH:
    def test_posterior_matches_exact_grid(self):
        run = pmmh(_log_marginal_est, _log_prior, n_iters=3000,
                   proposal=0.08)
        res = jax.jit(lambda k: run(k, jnp.asarray(0.0)))(KEY)
        chain = np.asarray(res.thetas)[500:]
        mean, std = _exact_grid_posterior()
        assert abs(chain.mean() - mean) < 0.05, (chain.mean(), mean)
        assert abs(chain.std() - std) < 0.05, (chain.std(), std)
        assert 0.05 < float(res.accept_rate) < 0.9

    def test_rejected_sweeps_keep_theta_and_logz(self):
        """With an impossible prior everywhere but theta0, nothing
        moves and logZ stays at its initial estimate."""

        def prior_point(a):
            return jnp.where(jnp.abs(a - 0.3) < 1e-6, 0.0, -jnp.inf)

        run = pmmh(_log_marginal_est, prior_point, n_iters=50,
                   proposal=0.5)
        res = jax.jit(lambda k: run(k, jnp.asarray(0.3)))(KEY)
        np.testing.assert_allclose(np.asarray(res.thetas), 0.3)
        assert float(res.accept_rate) == 0.0
        assert np.unique(np.asarray(res.log_zs)).size == 1

    def test_pytree_theta_and_custom_proposal(self):
        """θ as a dict pytree with a per-leaf proposal std."""

        def est(key, theta):
            return _log_marginal_est(key, theta["a"])

        def prior(theta):
            return _log_prior(theta["a"])

        prop = gaussian_walk_proposal({"a": 0.08})
        run = pmmh(est, prior, n_iters=200, proposal=prop)
        res = jax.jit(lambda k: run(k, {"a": jnp.asarray(0.2)}))(KEY)
        assert res.thetas["a"].shape == (200,)
        assert jnp.isfinite(res.log_zs).all()


def test_gaussian_walk_proposal_rejects_structure_mismatch():
    prop = gaussian_walk_proposal([0.1, 0.2])  # list vs tuple theta
    with pytest.raises(TypeError, match="structure"):
        prop(jax.random.key(0), (jnp.asarray(0.0), jnp.asarray(1.0)))
    # scalar std broadcasts; matching structure works per-leaf
    ok = gaussian_walk_proposal(0.1)(jax.random.key(0),
                                     (jnp.asarray(0.0), jnp.asarray(1.0)))
    assert len(ok) == 2


def test_pmmh_with_trace_level_estimator():
    """Full-stack composition: the pseudo-marginal estimator is the
    GFI-native trace_particle_filter's logZ on an @gen Scan model whose
    transition coefficient is the sampled parameter — no hand-written
    kernels anywhere in the chain."""
    import genjax_xla as g
    from genjax_xla.inference import trace_particle_filter

    t = 20
    ys20 = YS[:t]

    def log_marginal(key, a):
        @g.gen
        def step(carry, _):
            prev = carry
            x = g.normal(a * prev, jnp.sqrt(Q)) @ "x"
            g.normal(x, jnp.sqrt(R)) @ "y"
            return x, x

        run = trace_particle_filter(
            step.scan(n=t), (0.0, None), "y", ys20, 512
        )
        return run(key).log_z

    run = pmmh(log_marginal, _log_prior, n_iters=2000, proposal=0.15)
    res = jax.jit(lambda k: run(k, jnp.asarray(0.0)))(KEY)
    chain = np.asarray(res.thetas)[500:]
    mean, std, _ = lgssm_grid_posterior(
        ys20, Q, R, jnp.linspace(-0.95, 0.95, 191)
    )
    assert abs(chain.mean() - float(mean)) < 0.12, (chain.mean(), mean)
    assert 0.03 < float(res.accept_rate) < 0.95
