"""Posterior predictive tests (inference/predictive.py): conjugate
moment checks from run_nuts (2 sample axes) and run_svgd (1 axis)
draws, and the uniform-leading-axes contract."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import genjax_xla as g
from genjax_xla.inference import (
    Target,
    posterior_predictive,
    run_nuts,
    run_svgd,
)

KEY = jax.random.key(777)


@g.gen
def model():
    mu = g.normal(0.0, 1.0) @ "mu"
    _ = g.normal(mu, 0.5) @ "y"


TARGET = Target(model, (), g.C["y"].set(1.0))
# Exact: posterior N(0.8, 0.2); predictive N(0.8, 0.2 + 0.25).


class TestFromNUTS:
    def test_predictive_moments(self):
        chms, _ = jax.jit(
            lambda k: run_nuts(TARGET, k, n_chains=8, num_warmup=100,
                               num_samples=300, max_depth=5)
        )(KEY)
        draws = g.C["mu"].set(chms["mu"])
        chs, rets = jax.jit(
            lambda k: posterior_predictive(TARGET, draws, k)
        )(jax.random.fold_in(KEY, 1))
        ys = np.asarray(chs["y"])
        assert ys.shape == (8, 300)
        assert abs(ys.mean() - 0.8) < 0.06
        assert abs(ys.std() - np.sqrt(0.45)) < 0.06
        # Latents pass through untouched.
        np.testing.assert_array_equal(
            np.asarray(chs["mu"]), np.asarray(chms["mu"])
        )

    def test_layout_independence(self):
        """Keys fold in the flat index: reshaping the sample axes
        permutes nothing — the same draw index gets the same key."""
        mus = jnp.linspace(-1.0, 1.0, 24).reshape(4, 6)
        chs, _ = posterior_predictive(
            TARGET, g.C["mu"].set(mus), KEY
        )
        chs2, _ = posterior_predictive(
            TARGET, g.C["mu"].set(mus.reshape(2, 12)), KEY
        )
        np.testing.assert_array_equal(
            np.asarray(chs["y"]).ravel(), np.asarray(chs2["y"]).ravel()
        )


class TestFromSVGD:
    def test_single_axis_draws(self):
        ens = jax.jit(
            lambda k: run_svgd(TARGET, k, n_particles=256, n_steps=300,
                               step_size=0.1)
        )(KEY)
        chs, rets = posterior_predictive(
            TARGET, g.C["mu"].set(ens["mu"]), jax.random.fold_in(KEY, 2),
            sample_ndims=1,
        )
        ys = np.asarray(chs["y"])
        assert ys.shape == (256,)
        assert abs(ys.mean() - 0.8) < 0.1


class TestContract:
    def test_mismatched_leading_axes_raise(self):
        draws = g.C["mu"].set(jnp.zeros((4, 6))) | g.C["z"].set(
            jnp.zeros((3, 6))
        )
        with pytest.raises(ValueError, match="leading sample axes"):
            posterior_predictive(TARGET, draws, KEY)

    def test_empty_draws_raise(self):
        with pytest.raises(ValueError, match="no choices"):
            posterior_predictive(TARGET, g.ChoiceMap.empty(), KEY)
