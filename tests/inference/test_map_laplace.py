"""MAP optimization + Laplace approximation: exactness on conjugate
Gaussian targets (where Laplace is exact), constrained supports through
the auto-derived bijectors, and evidence-estimate accuracy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy import stats as sps

import genjax_xla as g
from genjax_xla.inference import Target
from genjax_xla.inference.map_laplace import (
    laplace_approximation,
    map_optimize,
)

KEY = jax.random.key(314159)


@g.gen
def conjugate_normal(obs_std):
    mu = g.normal(0.0, 1.0) @ "mu"
    y = g.normal(mu, obs_std) @ "y"
    return y


class TestGaussianExact:
    """For a Gaussian posterior the Laplace approximation is exact:
    mean = posterior mean, cov = posterior variance, log_z = the true
    evidence log p(y) = N(y; 0, 1 + obs_std^2)."""

    def _target(self, y=1.0, obs_std=0.5):
        return Target(conjugate_normal, (obs_std,), g.C["y"].set(y))

    def test_map_is_posterior_mean(self):
        tgt = self._target()
        res = jax.jit(
            lambda k: map_optimize(k, tgt, n_steps=800)
        )(KEY)
        want = 1.0 / (1.0 + 0.25)      # y / (1 + obs_std^2)
        assert abs(float(res.choices["mu"]) - want) < 1e-3
        # losses decrease to the optimum
        assert float(res.losses[-1]) <= float(res.losses[0])

    def test_laplace_exact_cov_and_evidence(self):
        y, obs_std = 1.0, 0.5
        tgt = self._target(y, obs_std)
        res = map_optimize(KEY, tgt, n_steps=800)
        lap = laplace_approximation(tgt, res.choices)
        post_var = obs_std**2 / (1 + obs_std**2)
        assert abs(float(lap.cov[0, 0]) - post_var) < 1e-3
        want_logz = sps.norm.logpdf(y, 0.0, np.sqrt(1 + obs_std**2))
        assert abs(float(lap.log_z) - want_logz) < 1e-3

    def test_vmapped_restarts(self):
        """Many random restarts in one program (the batching story)."""
        tgt = self._target()
        keys = jax.random.split(KEY, 8)
        res = jax.jit(jax.vmap(
            lambda k: map_optimize(k, tgt, n_steps=1000).choices["mu"]
        ))(keys)
        assert np.allclose(np.asarray(res), 0.8, atol=5e-3)


class TestConstrainedSupports:
    def test_beta_bernoulli_auto_transforms(self):
        """MAP of p under an interval support via transforms='auto';
        with include_jacobian=False this is the constrained-space mode
        (a+k-1)/(a+b+n-2)."""

        @g.gen
        def bb():
            p = g.beta(3.0, 2.0) @ "p"
            for i in range(4):
                _ = g.flip(p) @ f"y{i}"
            return p

        obs = g.C["y0"].set(True) | g.C["y1"].set(True) | \
            g.C["y2"].set(False) | g.C["y3"].set(True)
        tgt = Target(bb, (), obs)
        res = jax.jit(lambda k: map_optimize(
            k, tgt, n_steps=1200, transforms="auto"
        ))(KEY)
        # posterior Beta(3+3, 2+1): mode = (6-1)/(6+3-2) = 5/7
        assert abs(float(res.choices["p"]) - 5.0 / 7.0) < 2e-3
        assert 0.0 < float(res.choices["p"]) < 1.0

    def test_laplace_evidence_beta_bernoulli(self):
        """Laplace log Z vs the exact beta-binomial evidence — the
        logit-space expansion should land within ~0.05 nats."""

        @g.gen
        def bb():
            p = g.beta(3.0, 2.0) @ "p"
            for i in range(6):
                _ = g.flip(p) @ f"y{i}"
            return p

        vals = [True, True, False, True, True, False]
        obs = g.C["y0"].set(vals[0])
        for i in range(1, 6):
            obs = obs | g.C[f"y{i}"].set(vals[i])
        tgt = Target(bb, (), obs)
        res = map_optimize(
            KEY, tgt, n_steps=1500, transforms="auto",
            include_jacobian=True,
        )
        lap = laplace_approximation(
            tgt, res.choices, transforms=res.transforms
        )
        # exact: Z = B(a+k, b+n-k)/B(a,b)
        from scipy.special import betaln

        k = sum(vals)
        want = betaln(3.0 + k, 2.0 + 6 - k) - betaln(3.0, 2.0)
        assert abs(float(lap.log_z) - want) < 5e-2

    def test_positive_support_gamma(self):
        """MAP of a gamma-rate model stays positive and matches the
        closed-form mode through the log bijector."""

        @g.gen
        def model():
            lam = g.gamma(3.0, 2.0) @ "lam"       # shape 3, rate 2
            _ = g.poisson(lam) @ "n"
            return lam

        tgt = Target(model, (), g.C["n"].set(4))
        res = jax.jit(lambda k: map_optimize(
            k, tgt, n_steps=1500, transforms="auto"
        ))(KEY)
        lam = float(res.choices["lam"])
        # posterior Gamma(3+4, 2+1): mode = (7-1)/3 = 2
        assert lam > 0.0
        assert abs(lam - 2.0) < 5e-3


class TestDiagnostics:
    def test_non_mode_point_poisons_log_z(self):
        """Expanding at a non-stationary point with negative curvature
        direction must not silently return a finite evidence."""

        @g.gen
        def bimodal():
            x = g.normal(0.0, 10.0) @ "x"
            _ = g.normal(x * x, 0.5) @ "y"   # posterior bimodal in x
            return x

        tgt = Target(bimodal, (), g.C["y"].set(4.0))
        # x = 0 is a local MINIMUM between the two modes at +-2.
        lap = laplace_approximation(tgt, g.C["x"].set(0.0))
        assert bool(jnp.isnan(lap.log_z))

    def test_uncovered_latent_raises(self):
        """A latent map that misses an unconstrained address must fail
        loudly (the expansion point would otherwise depend on hidden
        fixed-key draws), unless the caller passes an explicit key."""

        @g.gen
        def two_latents():
            a = g.normal(0.0, 1.0) @ "a"
            b = g.normal(a, 1.0) @ "b"
            _ = g.normal(b, 0.5) @ "y"
            return b

        tgt = Target(two_latents, (), g.C["y"].set(1.0))
        with pytest.raises(ValueError, match="does not cover"):
            laplace_approximation(tgt, g.C["a"].set(0.5))
        # explicit key: caller owns the fill-in draws; no raise
        lap = laplace_approximation(
            tgt, g.C["a"].set(0.5), key=jax.random.key(7)
        )
        assert lap.cov.shape == (2, 2)
