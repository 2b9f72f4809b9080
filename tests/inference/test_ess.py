"""Elliptical slice sampling tests (inference/requests/ess.py):
kernel-level conjugate posterior recovery, trace-level request with the
GFI prior/likelihood split, nonzero prior mean, and vmapped chains."""

import jax
import jax.numpy as jnp
import numpy as np

import genjax_xla as g
from genjax_xla.inference import EllipticalSlice, Target, mh
from genjax_xla.inference.requests.ess import elliptical_slice_kernel

KEY = jax.random.key(1618)


class TestKernel:
    def test_conjugate_gaussian_moments(self):
        """Prior N(0, 1) x likelihood N(z; y=1, 0.5^2) in 1-D: posterior
        N(0.8, 0.2). The kernel gets the likelihood only; nu is a fresh
        prior draw per transition."""

        def loglik(z):
            return -0.5 * jnp.sum((z - 1.0) ** 2 / 0.25)

        def step(z, key):
            k_nu, k_kern = jax.random.split(key)
            nu = jax.random.normal(k_nu, (1,))
            z_new, _ = elliptical_slice_kernel(loglik, z, nu, k_kern)
            return z_new, z_new

        _, zs = jax.lax.scan(
            step, jnp.zeros(1), jax.random.split(KEY, 4000)
        )
        zs = np.asarray(zs)[500:]
        assert abs(zs.mean() - 0.8) < 0.05
        assert abs(zs.std() - np.sqrt(0.2)) < 0.05

    def test_nonzero_prior_mean(self):
        """Prior N(3, 1), flat-ish likelihood: the ellipse must rotate
        about the prior mean or the chain drifts off target."""

        def loglik(z):
            return -0.5 * jnp.sum((z - 3.5) ** 2 / 4.0)

        def step(z, key):
            k_nu, k_kern = jax.random.split(key)
            nu = 3.0 + jax.random.normal(k_nu, (1,))
            z_new, _ = elliptical_slice_kernel(
                loglik, z, nu, k_kern, mean=3.0
            )
            return z_new, z_new

        _, zs = jax.lax.scan(
            step, jnp.full((1,), 3.0), jax.random.split(KEY, 4000)
        )
        zs = np.asarray(zs)[500:]
        # Exact posterior: precision 1 + 1/4 -> N(3.1, 0.8).
        assert abs(zs.mean() - 3.1) < 0.07
        assert abs(zs.std() - np.sqrt(0.8)) < 0.07


class TestTraceRequest:
    def test_conjugate_posterior_via_request(self):
        @g.gen
        def model():
            mu = g.normal(0.0, 1.0) @ "mu"
            _ = g.normal(mu, 0.5) @ "y"

        target = Target(model, (), g.C["y"].set(1.0))
        req = EllipticalSlice(g.Selection.at["mu"])

        tr, _ = target.importance(jax.random.fold_in(KEY, 0), g.ChoiceMap.empty())

        def step(tr, key):
            new_tr, accepted = mh(key, tr, req)
            return new_tr, new_tr.get_choices()["mu"]

        _, mus = jax.lax.scan(step, tr, jax.random.split(KEY, 3000))
        mus = np.asarray(mus)[500:]
        assert abs(mus.mean() - 0.8) < 0.05
        assert abs(mus.std() - np.sqrt(0.2)) < 0.05

    def test_hierarchical_conditional_gaussian(self):
        """Selected site's prior mean depends on an UNSELECTED choice —
        still conditionally Gaussian, so ESS with prior_mean supplied at
        the conditioning value stays exact for the conditional move."""

        @g.gen
        def model():
            top = g.normal(0.0, 1.0) @ "top"
            mid = g.normal(top, 1.0) @ "mid"
            _ = g.normal(mid, 0.5) @ "y"

        target = Target(model, (), g.C["y"].set(2.0))
        # Condition on top's current value each step by rebuilding the
        # request from the trace (prior mean = top).
        tr, _ = target.importance(jax.random.fold_in(KEY, 1), g.ChoiceMap.empty())

        def step(tr, key):
            top = tr.get_choices()["top"]
            req = EllipticalSlice(
                g.Selection.at["mid"], prior_mean=top
            )
            new_tr, _ = mh(key, tr, req)
            return new_tr, new_tr.get_choices()["mid"]

        _, mids = jax.lax.scan(step, tr, jax.random.split(KEY, 3000))
        mids = np.asarray(mids)[500:]
        # top is fixed at its initial draw; the conditional posterior of
        # mid given (top, y=2) is N((top + 4*2)/5, 1/5).
        top0 = float(np.asarray(tr.get_choices()["top"]))
        assert abs(mids.mean() - (top0 + 8.0) / 5.0) < 0.06
        assert abs(mids.std() - np.sqrt(0.2)) < 0.06

    def test_vmapped_chains(self):
        @g.gen
        def model():
            mu = g.normal(0.0, 1.0) @ "mu"
            _ = g.normal(mu, 0.5) @ "y"

        target = Target(model, (), g.C["y"].set(1.0))
        req = EllipticalSlice(g.Selection.at["mu"])

        def one_chain(c):
            key = jax.random.fold_in(KEY, c)
            tr, _ = target.importance(key, g.ChoiceMap.empty())

            def step(tr, k):
                new_tr, _ = mh(k, tr, req)
                return new_tr, new_tr.get_choices()["mu"]

            _, mus = jax.lax.scan(step, tr, jax.random.split(key, 400))
            return mus

        mus = jax.jit(jax.vmap(one_chain))(jnp.arange(32))
        mus = np.asarray(mus)[:, 100:]
        assert abs(mus.mean() - 0.8) < 0.05
        assert np.isfinite(mus).all()


class TestGaussianGuard:
    def test_non_gaussian_selected_site_raises(self):
        """ADVICE r4: selecting a non-Gaussian site must raise at probe
        time — ESS on it would silently sample a wrong stationary
        distribution."""
        import pytest

        @g.gen
        def model():
            r = g.gamma(2.0, 2.0) @ "r"
            _ = g.normal(r, 0.5) @ "y"

        target = Target(model, (), g.C["y"].set(1.0))
        tr, _ = target.importance(KEY, g.ChoiceMap.empty())
        req = EllipticalSlice(g.Selection.at["r"])
        with pytest.raises(ValueError, match="gamma"):
            tr.edit(jax.random.fold_in(KEY, 1), req)

    def test_gaussian_site_passes_guard(self):
        @g.gen
        def model():
            mu = g.normal(0.0, 1.0) @ "mu"
            r = g.gamma(2.0, 2.0) @ "r"
            _ = g.normal(mu, 0.5) @ "y"

        target = Target(model, (), g.C["y"].set(1.0))
        tr, _ = target.importance(KEY, g.ChoiceMap.empty())
        # Selecting only the Gaussian site is fine even though a gamma
        # site exists elsewhere in the trace.
        req = EllipticalSlice(g.Selection.at["mu"])
        new_tr, w, _rd, _bwd = tr.edit(jax.random.fold_in(KEY, 2), req)
        assert float(w) == 0.0

    def test_check_gaussian_escape_hatch(self):
        """Review r5: a custom Gaussian density (name unknown to the
        whitelist) needs check_gaussian=False to run — and then the
        chain still targets the right posterior."""
        import pytest

        my_normal = g.exact_density(
            lambda key, mu, sigma: mu + sigma * jax.random.normal(key),
            lambda v, mu, sigma: jax.scipy.stats.norm.logpdf(
                v, mu, sigma
            ),
            "my_normal",
        )

        @g.gen
        def model():
            mu = my_normal(0.0, 1.0) @ "mu"
            _ = g.normal(mu, 0.5) @ "y"

        target = Target(model, (), g.C["y"].set(1.0))
        tr, _ = target.importance(KEY, g.ChoiceMap.empty())
        with pytest.raises(ValueError, match="my_normal"):
            tr.edit(KEY, EllipticalSlice(g.Selection.at["mu"]))
        req = EllipticalSlice(
            g.Selection.at["mu"], check_gaussian=False
        )

        def step(tr, key):
            new_tr, _ = mh(key, tr, req)
            return new_tr, new_tr.get_choices()["mu"]

        _, mus = jax.lax.scan(step, tr, jax.random.split(KEY, 2500))
        mus = np.asarray(mus)[500:]
        assert abs(mus.mean() - 0.8) < 0.06
