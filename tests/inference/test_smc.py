"""SMC tests: logZ̄ vs exact marginals on conjugate models; the README
quickstart posterior; ESS/resampling invariants.

Mirrors ``/root/reference/tests/inference/test_smc.py`` (logZ accuracy at
K=1 / K=1000 within 1e-1 / 1e-3 — SURVEY §6) and the README beta-bernoulli
functional reference point (p̂ ≈ 0.60 / 0.37, ``README.md:109-123``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import genjax_xla as g
from genjax_xla.inference import (
    Importance,
    ImportanceK,
    Target,
    effective_sample_size,
    resample_indices,
)
from genjax_xla.inference.smc import resample_indices_rows

KEY = jax.random.key(314159)


@g.gen
def beta_bernoulli(a, b):
    p = g.beta(a, b) @ "p"
    v = g.flip(p) @ "v"
    return v


def exact_log_marginal(obs: bool) -> float:
    # P(v=obs) under Beta(2,2) prior = E[p] or 1-E[p] = 0.5 either way.
    return float(np.log(0.5))


class TestLogZ:
    def test_logz_k1_within_1e1(self):
        target = Target(beta_bernoulli, (2.0, 2.0), g.C["v"].set(True))
        alg = Importance(target)
        keys = jax.random.split(KEY, 200)
        est = jax.vmap(
            lambda k: alg.log_marginal_likelihood_estimate(k)
        )(keys)
        logz = jax.scipy.special.logsumexp(est) - jnp.log(len(est))
        assert jnp.abs(logz - exact_log_marginal(True)) < 1e-1

    def test_logz_k1000_within_1e3(self):
        target = Target(beta_bernoulli, (2.0, 2.0), g.C["v"].set(True))
        alg = ImportanceK(target, k_particles=1000)
        keys = jax.random.split(KEY, 20)
        est = jax.vmap(
            lambda k: alg.log_marginal_likelihood_estimate(k)
        )(keys)
        logz = jax.scipy.special.logsumexp(est) - jnp.log(len(est))
        assert jnp.abs(logz - exact_log_marginal(True)) < 1e-2


class TestReadmeQuickstart:
    def test_posterior_means(self):
        """README.md:95-123 — SIR posterior mean of p, K=50 x 50 trials.

        Exact posterior means: Beta(3,2) → 0.6 (obs True), Beta(2,3) → 0.4
        (obs False). SIR with K=50 is slightly biased toward the prior; the
        reference reports 0.604 / 0.368."""

        @jax.jit
        def run_inference(obs):
            target = Target(beta_bernoulli, (2.0, 2.0), g.C["v"].set(obs))
            alg = ImportanceK(target, k_particles=50)
            sub_keys = jax.random.split(KEY, 50)
            _, p_chm = jax.vmap(alg.random_weighted, in_axes=(0, None))(
                sub_keys, target
            )
            return jnp.mean(p_chm["p"])

        p_true = run_inference(True)
        p_false = run_inference(False)
        assert jnp.abs(p_true - 0.6) < 0.05
        assert jnp.abs(p_false - 0.4) < 0.05


class TestGenSP:
    def test_estimate_logpdf_exactly_unbiased_enumerated(self):
        """E[exp(W)] must equal the SIR output density q_SIR(v) *exactly*
        (ADH identity) — checked against hand-enumeration on a two-flip
        model with K=2: q_SIR(x=1) = 0.426."""

        @g.gen
        def two_flip():
            x = g.flip(0.3) @ "x"
            y = g.flip(jnp.where(x, 0.8, 0.2)) @ "y"
            return y

        target = Target(two_flip, (), g.C["y"].set(True))
        alg = ImportanceK(target, k_particles=2)
        keys = jax.random.split(KEY, 40_000)
        est = jax.vmap(
            lambda k: alg.estimate_logpdf(k, g.C["x"].set(True), target)
        )(keys)
        got = jnp.exp(
            jax.scipy.special.logsumexp(est) - jnp.log(len(est))
        )
        assert jnp.abs(got - 0.426) < 5e-3

    def test_estimate_logpdf_k1_is_prior(self):
        """With K=1 and no proposal, SIR's output density is the prior."""
        target = Target(beta_bernoulli, (2.0, 2.0), g.C["v"].set(True))
        alg = Importance(target)
        from scipy.stats import beta as sbeta

        est = alg.estimate_logpdf(KEY, g.C["p"].set(0.7), target)
        assert jnp.abs(est - sbeta(2, 2).logpdf(0.7)) < 1e-5

    def test_estimate_logpdf_approaches_posterior(self):
        target = Target(beta_bernoulli, (2.0, 2.0), g.C["v"].set(True))
        alg = ImportanceK(target, k_particles=100)
        keys = jax.random.split(KEY, 500)
        est = jax.vmap(
            lambda k: alg.estimate_logpdf(k, g.C["p"].set(0.7), target)
        )(keys)
        from scipy.stats import beta as sbeta

        want = sbeta(3, 2).logpdf(0.7)
        got = jax.scipy.special.logsumexp(est) - jnp.log(len(est))
        assert jnp.abs(got - want) < 5e-2


class TestResampling:
    def test_ess_uniform_weights(self):
        lw = jnp.zeros(64)
        assert jnp.allclose(effective_sample_size(lw), 64.0)

    def test_ess_degenerate(self):
        lw = jnp.array([0.0] + [-jnp.inf] * 63)
        assert jnp.allclose(effective_sample_size(lw), 1.0)

    def test_systematic_counts_match_weights(self):
        lw = jnp.log(jnp.array([0.1, 0.2, 0.3, 0.4]))
        idx = resample_indices(KEY, lw, 4000, "systematic")
        counts = np.bincount(np.asarray(idx), minlength=4) / 4000
        np.testing.assert_allclose(counts, [0.1, 0.2, 0.3, 0.4], atol=0.01)

    def test_stratified_and_multinomial(self):
        lw = jnp.log(jnp.array([0.25, 0.25, 0.5]))
        for method in ["stratified", "multinomial"]:
            idx = resample_indices(KEY, lw, 6000, method)
            counts = np.bincount(np.asarray(idx), minlength=3) / 6000
            np.testing.assert_allclose(counts, [0.25, 0.25, 0.5], atol=0.03)

    def test_collection_resample_preserves_logz(self):
        target = Target(beta_bernoulli, (2.0, 2.0), g.C["v"].set(True))
        alg = ImportanceK(target, k_particles=256)
        col = alg.run_smc(KEY)
        res = col.resample(jax.random.key(1))
        assert jnp.allclose(
            res.get_log_marginal_likelihood_estimate(),
            col.get_log_marginal_likelihood_estimate(),
            atol=1e-5,
        )
        assert jnp.allclose(res.effective_sample_size(), 256.0)


class TestMarginal:
    def test_marginal_density_estimate(self):
        """Marginal of `p` in beta_bernoulli (marginalizing v) should have
        density equal to the Beta prior pdf (v sums out)."""
        m = beta_bernoulli.marginal(selection=g.S.at["p"])
        keys = jax.random.split(KEY, 100)
        est = jax.vmap(
            lambda k: m.estimate_logpdf(k, g.C["p"].set(0.3), 2.0, 2.0)
        )(keys)
        from scipy.stats import beta as sbeta

        want = sbeta(2, 2).logpdf(0.3)
        got = jax.scipy.special.logsumexp(est) - jnp.log(len(est))
        assert jnp.abs(got - want) < 5e-2


class TestMarginalWithAlgorithm:
    def test_marginal_with_importancek_algorithm(self):
        """Marginal backed by a K-particle algorithm instead of the
        default 1-particle Importance."""
        m = beta_bernoulli.marginal(
            selection=g.S.at["p"],
            algorithm=ImportanceK(
                Target(beta_bernoulli, (2.0, 2.0), g.ChoiceMap.empty()),
                k_particles=8,
            ),
        )
        keys = jax.random.split(KEY, 100)
        est = jax.vmap(
            lambda k: m.estimate_logpdf(k, g.C["p"].set(0.3), 2.0, 2.0)
        )(keys)
        from scipy.stats import beta as sbeta

        want = sbeta(2, 2).logpdf(0.3)
        got = jax.scipy.special.logsumexp(est) - jnp.log(len(est))
        assert jnp.abs(got - want) < 5e-2


class TestMarginalRandomWeightedWithAlgorithm:
    """random_weighted under a CUSTOM (K-particle) marginalization
    algorithm (ROADMAP gap: only estimate_logpdf was covered).
    Convention (sp.py SampleDistribution): the returned estimate is
    density-reciprocal-unbiased, E[exp(-est) | value] = 1/p(value),
    so over joint draws E[exp(true_logpdf(value) - est)] = 1."""

    def test_random_weighted_reciprocal_unbiased(self):
        from scipy.stats import beta as sbeta

        m = beta_bernoulli.marginal(
            selection=g.S.at["p"],
            algorithm=ImportanceK(
                Target(beta_bernoulli, (2.0, 2.0), g.ChoiceMap.empty()),
                k_particles=8,
            ),
        )
        keys = jax.random.split(jax.random.key(17), 3000)
        ests, ps = jax.vmap(
            lambda k: (
                lambda est_latent: (
                    est_latent[0], est_latent[1]["p"]
                )
            )(m.random_weighted(k, 2.0, 2.0))
        )(keys)
        true = jnp.asarray(sbeta(2, 2).logpdf(np.asarray(ps)))
        # mean of exp(true - est) -> 1 (reciprocal unbiasedness)
        log_mean = jax.scipy.special.logsumexp(
            true - ests
        ) - jnp.log(len(keys))
        assert jnp.abs(log_mean) < 5e-2
        # the sampled values follow the marginal (Beta(2,2)) prior
        assert jnp.abs(ps.mean() - 0.5) < 2e-2


class TestMarginalAsSite:
    """A Marginal (chm-valued SampleDistribution) used at an `@ addr` site
    inside another model: nested constraints must be honored and the outer
    logZ must equal the inner marginal density (stochastic probabilities;
    reference `docs/cookbook/inactive/expressivity/stochastic_probabilities.ipynb`)."""

    def _outer(self):
        @g.gen
        def mixture():
            hot = g.flip(0.3) @ "hot"
            mu = jnp.where(hot, 4.0, 0.0)
            return g.normal(mu, 1.0) @ "value"

        value_dist = mixture.marginal(selection=g.S.at["value"])

        @g.gen
        def outer(shift):
            r = value_dist() @ "reading"
            return r["value"] + shift

        return outer

    def test_nested_constraint_is_honored(self):
        outer = self._outer()
        obs = g.C["reading"].set(g.C["value"].set(1.0))
        tr, w = outer.generate(KEY, obs, (1.0,))
        # Constraint must actually bind (bug r2: valueless submap was
        # silently ignored -> weight 0, prior draw retained).
        assert jnp.allclose(tr.get_retval(), 2.0)
        assert float(w) != 0.0

    def test_outer_logz_matches_closed_form(self):
        outer = self._outer()
        v = 1.0
        obs = g.C["reading"].set(g.C["value"].set(v))
        keys = jax.random.split(KEY, 2000)
        _, ws = jax.jit(
            jax.vmap(lambda k: outer.generate(k, obs, (1.0,)))
        )(keys)
        logz = jax.scipy.special.logsumexp(ws) - jnp.log(len(ws))
        import jax.scipy.stats as jss

        closed = jnp.log(
            0.7 * jnp.exp(jss.norm.logpdf(v, 0.0, 1.0))
            + 0.3 * jnp.exp(jss.norm.logpdf(v, 4.0, 1.0))
        )
        assert jnp.abs(logz - closed) < 5e-2


def test_non_marginal_target():
    """Parity: reference ``test_smc.py test_non_marginal_target`` —
    a Marginal model is rejected at Target construction."""
    @g.gen
    def model():
        idx = g.categorical(probs=jnp.array([0.5, 0.25, 0.25])) @ "idx"
        means = jnp.array([0.0, 10.0, 11.0])
        x = g.normal(means[idx], 1.0) @ "x"
        return x

    marg = model.marginal(selection=g.Selection.at["x"])
    with pytest.raises(TypeError, match="Marginal"):
        Target(marg, (), g.C["x"].set(1.0))


class TestRowResampling:
    """Row-batched resampling primitive (`resample_indices_rows`),
    incl. the systematic scheme (VERDICT r2 item 6)."""

    def test_systematic_matches_searchsorted_oracle(self):
        """Bitwise vs a per-row numpy searchsorted of the same CDF and
        grid (the merge sort computes exactly #{cum <= u} per query)."""
        r, k, n = 16, 64, 128
        lw = jax.random.normal(jax.random.key(0), (r, k)) * 2.0
        key = jax.random.key(1)
        got = np.asarray(
            resample_indices_rows(key, lw, n, method="systematic")
        )
        norm = jax.nn.softmax(lw, axis=1)
        cum = np.asarray(jnp.cumsum(norm, axis=1))
        u0 = np.asarray(jax.random.uniform(key, (r, 1)))
        us = (u0 + np.arange(n)[None, :]) / n
        for i in range(r):
            want = np.clip(
                np.searchsorted(cum[i], us[i], side="right"), 0, k - 1
            )
            np.testing.assert_array_equal(got[i], want)

    def test_systematic_matches_repeat_expansion(self):
        """Counts derived from the same grid reproduce the ancestors via
        a per-row `jnp.repeat` (run-length) expansion."""
        r, k, n = 8, 32, 256
        lw = jax.random.normal(jax.random.key(2), (r, k))
        key = jax.random.key(3)
        got = np.asarray(
            resample_indices_rows(key, lw, n, method="systematic")
        )
        norm = jax.nn.softmax(lw, axis=1)
        cum = np.asarray(jnp.cumsum(norm, axis=1))
        u0 = np.asarray(jax.random.uniform(key, (r, 1)))[:, 0]
        for i in range(r):
            # counts_cum = #{j : (j + u0)/n < cum_i} with the same float
            # comparisons as the merge (grid values compared directly).
            us = (u0[i] + np.arange(n)) / n
            counts_cum = np.sum(us[None, :] >= cum[i][:, None], axis=1)
            counts_cum = n - counts_cum  # #{us < cum_i}
            counts = np.diff(np.concatenate([[0], counts_cum]))
            # guard: total dests == n (tail may clip otherwise)
            counts[-1] += n - counts.sum()
            want = np.repeat(np.arange(k), counts)
            np.testing.assert_array_equal(np.sort(got[i]), want)

    def test_systematic_lower_offspring_variance_than_multinomial(self):
        """The headline property: offspring-count variance (hence logZ
        variance contribution) strictly drops vs multinomial."""
        r, k = 256, 64
        lw = jax.random.normal(jax.random.key(4), (r, k))
        probs = np.asarray(jax.nn.softmax(lw, axis=1))

        def offspring_var(method):
            idx = np.asarray(
                resample_indices_rows(
                    jax.random.key(5), lw, k, method=method
                )
            )
            var = 0.0
            for i in range(r):
                counts = np.bincount(idx[i], minlength=k)
                var += np.mean((counts - k * probs[i]) ** 2)
            return var / r

        v_sys = offspring_var("systematic")
        v_mult = offspring_var("multinomial")
        assert v_sys < 0.5 * v_mult, (v_sys, v_mult)

    def test_all_methods_sorted_and_in_range(self):
        r, k, n = 8, 100, 500
        lw = jax.random.normal(jax.random.key(6), (r, k)) * 3.0
        for method in ("systematic", "stratified", "multinomial"):
            idx = np.asarray(
                resample_indices_rows(
                    jax.random.key(7), lw, n, method=method
                )
            )
            assert (np.diff(idx, axis=1) >= 0).all(), method
            assert (idx >= 0).all() and (idx < k).all(), method

    def test_row_counts_match_weights(self):
        lw = jnp.log(jnp.tile(jnp.array([0.1, 0.2, 0.3, 0.4]), (5, 1)))
        idx = np.asarray(
            resample_indices_rows(KEY, lw, 4000, method="systematic")
        )
        for i in range(5):
            counts = np.bincount(idx[i], minlength=4) / 4000
            np.testing.assert_allclose(
                counts, [0.1, 0.2, 0.3, 0.4], atol=0.01
            )


class TestSortedResample:
    """Single-row sort-based ancestor draw (`resample_indices_sorted`),
    the vmap-friendly primitive of SMC²'s per-θ inner-filter re-runs."""

    @staticmethod
    def _grid(key, n, method):
        if method == "systematic":
            return (jax.random.uniform(key, ()) + jnp.arange(n)) / n
        if method == "stratified":
            return (jax.random.uniform(key, (n,)) + jnp.arange(n)) / n
        es = jax.random.exponential(key, (n + 1,))
        return jnp.cumsum(es)[:-1] / jnp.sum(es)

    @pytest.mark.parametrize("method", ["systematic", "stratified",
                                        "multinomial"])
    @pytest.mark.parametrize("seed,scale", [(0, 1.0), (1, 4.0), (2, 0.1)])
    def test_matches_searchsorted_oracle(self, method, seed, scale):
        """Bitwise vs numpy searchsorted(side='right') of the same CDF
        and the same grid: the merge sort counts #{cum <= u}."""
        from genjax_xla.inference.smc import resample_indices_sorted

        k, n = 256, 200
        key = jax.random.key(seed)
        lw = jax.random.normal(jax.random.fold_in(key, 1), (k,)) * scale
        got = np.asarray(jax.jit(
            lambda kk, w: resample_indices_sorted(kk, w, n, method)
        )(key, lw))
        cum = np.asarray(jnp.cumsum(jax.nn.softmax(lw)))
        us = np.asarray(self._grid(key, n, method))
        want = np.clip(np.searchsorted(cum, us, side="right"), 0, k - 1)
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("method", ["systematic", "stratified",
                                        "multinomial"])
    def test_degenerate_weights(self, method):
        from genjax_xla.inference.smc import resample_indices_sorted

        lw = jnp.full((128,), -1e9).at[5].set(0.0)
        got = resample_indices_sorted(jax.random.key(3), lw, 128, method)
        np.testing.assert_array_equal(np.asarray(got), np.full(128, 5))

    def test_vmap_matches_per_row_calls(self):
        from genjax_xla.inference.smc import resample_indices_sorted

        keys = jax.random.split(jax.random.key(11), 4)
        lw = jax.random.normal(jax.random.key(12), (4, 32)) * 2.0
        batched = np.asarray(jax.vmap(
            lambda kk, w: resample_indices_sorted(kk, w, 48)
        )(keys, lw))
        for r in range(4):
            np.testing.assert_array_equal(
                batched[r],
                np.asarray(resample_indices_sorted(keys[r], lw[r], 48)),
            )

    def test_property_systematic_offspring_counts(self):
        """Hypothesis sweep: systematic offspring counts conserve n, the
        ancestors are non-decreasing, and each particle gets floor or
        ceil of n·w_i dests (one more or fewer only at f32 ties)."""
        from hypothesis import given, settings
        from hypothesis import strategies as st

        from genjax_xla.inference.smc import resample_indices_sorted

        @given(st.integers(0, 2**16), st.sampled_from([8, 33, 127, 256]),
               st.floats(0.1, 8.0))
        @settings(max_examples=25, deadline=None)
        def check(seed, k, scale):
            key = jax.random.key(seed)
            lw = jax.random.normal(jax.random.fold_in(key, 1), (k,)) * scale
            anc = np.asarray(resample_indices_sorted(key, lw, k))
            assert (np.diff(anc) >= 0).all()
            counts = np.bincount(anc, minlength=k)
            assert counts.sum() == k
            expect = k * np.asarray(jax.nn.softmax(lw), np.float64)
            assert (counts >= np.floor(expect) - 1).all()
            assert (counts <= np.ceil(expect) + 1).all()

        check()

    def test_unknown_method_raises(self):
        from genjax_xla.inference.smc import resample_indices_sorted

        with pytest.raises(ValueError, match="Unknown resampling method"):
            resample_indices_sorted(jax.random.key(0), jnp.zeros(8), 8,
                                    method="nope")
