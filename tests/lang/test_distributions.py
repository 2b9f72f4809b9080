"""Distribution stdlib tests: sampler/logpdf consistency, moment checks
against closed forms, and GFI conformance of ``ExactDensity``.

Mirrors ``/root/reference/tests/generative_functions/test_distributions.py``
(sampling/logpdf checks), with scipy.stats (CPU, via numpy) as the density
oracle where available.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as sps

import genjax_xla as g

KEY = jax.random.key(314159)
N = 20_000


def moments(d, args, n=N):
    keys = jax.random.split(KEY, n)
    xs = jax.vmap(lambda k: d.sample(k, *args))(keys)
    return np.asarray(xs)


# (dist, args, scipy_frozen, test_values)
CASES = [
    (g.normal, (0.5, 2.0), sps.norm(0.5, 2.0), [0.0, 1.0, -3.0]),
    (g.cauchy, (0.0, 1.5), sps.cauchy(0.0, 1.5), [0.0, 2.0]),
    (g.laplace, (1.0, 2.0), sps.laplace(1.0, 2.0), [0.0, 3.0]),
    (g.logistic, (0.0, 1.0), sps.logistic(0.0, 1.0), [0.0, 1.0]),
    (g.gumbel, (0.5, 1.2), sps.gumbel_r(0.5, 1.2), [0.0, 2.0]),
    (g.student_t, (4.0, 0.0, 1.0), sps.t(4.0), [0.0, 1.5]),
    (g.uniform, (1.0, 3.0), sps.uniform(1.0, 2.0), [1.5, 2.5]),
    (g.exponential, (2.0,), sps.expon(scale=0.5), [0.5, 2.0]),
    (g.beta, (2.0, 3.0), sps.beta(2.0, 3.0), [0.3, 0.7]),
    (g.gamma, (2.0, 3.0), sps.gamma(2.0, scale=1 / 3.0), [0.5, 1.5]),
    (g.inverse_gamma, (3.0, 2.0), sps.invgamma(3.0, scale=2.0), [0.5, 1.5]),
    (g.chi2, (3.0,), sps.chi2(3.0), [1.0, 4.0]),
    (g.chi, (3.0,), sps.chi(3.0), [1.0, 2.0]),
    (g.weibull, (2.0, 1.5), sps.weibull_min(2.0, scale=1.5), [0.5, 2.0]),
    (g.log_normal, (0.0, 1.0), sps.lognorm(1.0), [0.5, 2.0]),
    (g.half_normal, (2.0,), sps.halfnorm(scale=2.0), [0.5, 3.0]),
    (g.half_cauchy, (0.0, 1.0), sps.halfcauchy(0.0, 1.0), [0.5, 3.0]),
    (
        g.truncated_normal,
        (0.0, 1.0, -1.0, 2.0),
        sps.truncnorm(-1.0, 2.0),
        [0.0, 1.0],
    ),
    (g.von_mises, (0.0, 2.0), sps.vonmises(2.0), [0.0, 1.0]),
    (g.inverse_gaussian, (1.0, 2.0), sps.invgauss(0.5, scale=2.0), [0.5, 1.5]),
    (g.moyal, (0.0, 1.0), sps.moyal(), [0.0, 2.0]),
    (g.poisson, (3.5,), sps.poisson(3.5), [0, 2, 5]),
    (g.geometric, (0.3,), sps.geom(0.3, loc=-1), [0, 1, 5]),
    (g.binomial, (10.0, 0.4), sps.binom(10, 0.4), [0, 4, 10]),
    (
        g.negative_binomial,
        (5.0, 0.4),
        sps.nbinom(5, 0.6),
        [0, 3, 8],
    ),
    (g.skellam, (2.0, 3.0), sps.skellam(2.0, 3.0), [-2, 0, 3]),
    (g.zipf, (2.5,), sps.zipf(2.5), [1, 2, 5]),
    (g.kumaraswamy, (2.0, 3.0), None, [0.3, 0.6]),
    (g.exp_gamma, (2.0, 1.0), None, [-0.5, 0.5]),
    (g.exp_inverse_gamma, (2.0, 1.0), None, [-0.5, 0.5]),
    (g.non_central_chi2, (3.0, 2.0), sps.ncx2(3.0, 2.0), [2.0, 5.0]),
    (g.double_sided_maxwell, (0.0, 1.0), None, [1.0, -1.5]),
    (g.truncated_cauchy, (0.0, 1.0, -2.0, 2.0), None, [0.0, 1.0]),
]


@pytest.mark.parametrize(
    "dist,args,frozen,values",
    [c for c in CASES if c[2] is not None],
    ids=lambda c: getattr(c, "name", repr(c))[:30],
)
def test_logpdf_matches_scipy(dist, args, frozen, values):
    for v in values:
        got = dist.logpdf(jnp.asarray(v, jnp.result_type(float)), *args)
        if hasattr(frozen, "logpdf"):
            want = frozen.logpdf(v)
        else:
            want = frozen.logpmf(v)
        np.testing.assert_allclose(np.sum(got), want, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize(
    "dist,args,frozen,values",
    [c for c in CASES if c[2] is not None],
    ids=lambda c: getattr(c, "name", repr(c))[:30],
)
def test_sample_moments(dist, args, frozen, values):
    mean, var = frozen.stats("mv")
    if not np.isfinite(mean):
        pytest.skip("undefined mean")
    xs = moments(dist, args)
    se = np.sqrt(var / len(xs)) if np.isfinite(var) else 0.1
    np.testing.assert_allclose(xs.mean(), mean, atol=max(6 * se, 5e-2))


def test_sampler_logpdf_consistency_no_scipy():
    # For dists without a scipy oracle: importance identity
    # E_q[exp(logp - logq)] = 1 with q = the dist itself => mean of
    # exp(0) = 1 trivially; instead check logpdf integrates to ~1 via
    # self-normalized check on a grid.
    for dist, args, lo, hi in [
        (g.kumaraswamy, (2.0, 3.0), 1e-4, 1 - 1e-4),
        (g.truncated_cauchy, (0.0, 1.0, -2.0, 2.0), -2.0, 2.0),
        (g.double_sided_maxwell, (0.0, 1.0), -8.0, 8.0),
        (g.exp_gamma, (2.0, 1.0), -12.0, 6.0),
        (g.exp_inverse_gamma, (2.0, 1.0), -6.0, 12.0),
    ]:
        grid = jnp.linspace(lo, hi, 20001)
        lp = jax.vmap(lambda v: dist.logpdf(v, *args))(grid)
        integral = jnp.trapezoid(jnp.exp(lp), grid)
        np.testing.assert_allclose(float(integral), 1.0, atol=2e-2)


def test_flip_and_bernoulli():
    lp_t = g.flip.logpdf(True, 0.3)
    np.testing.assert_allclose(float(lp_t), np.log(0.3), rtol=1e-6)
    logits = np.log(0.3 / 0.7)
    lp_b = g.bernoulli.logpdf(True, logits)
    np.testing.assert_allclose(float(lp_b), np.log(0.3), rtol=1e-5)
    ks = jax.random.split(KEY, 10000)
    xs = jax.vmap(lambda k: g.flip.sample(k, 0.3))(ks)
    np.testing.assert_allclose(np.mean(np.asarray(xs)), 0.3, atol=0.02)


def test_categorical():
    logits = jnp.log(jnp.array([0.1, 0.2, 0.7]))
    for v, p in [(0, 0.1), (1, 0.2), (2, 0.7)]:
        np.testing.assert_allclose(
            float(g.categorical.logpdf(v, logits)), np.log(p), rtol=1e-5
        )
    ks = jax.random.split(KEY, 20000)
    xs = np.asarray(jax.vmap(lambda k: g.categorical.sample(k, logits))(ks))
    np.testing.assert_allclose(np.mean(xs == 2), 0.7, atol=0.02)


def test_mv_normal_diag():
    loc = jnp.array([0.0, 1.0])
    sd = jnp.array([1.0, 2.0])
    v = jnp.array([0.5, 0.5])
    want = sps.multivariate_normal(np.asarray(loc), np.diag(np.asarray(sd) ** 2)).logpdf(
        np.asarray(v)
    )
    np.testing.assert_allclose(
        float(g.mv_normal_diag.logpdf(v, loc, sd)), want, rtol=1e-5
    )


def test_mv_normal():
    loc = jnp.array([0.0, 1.0])
    cov = jnp.array([[2.0, 0.5], [0.5, 1.0]])
    v = jnp.array([0.5, 0.5])
    want = sps.multivariate_normal(np.asarray(loc), np.asarray(cov)).logpdf(
        np.asarray(v)
    )
    np.testing.assert_allclose(
        float(g.mv_normal.logpdf(v, loc, cov)), want, rtol=1e-5
    )


def test_dirichlet():
    conc = jnp.array([2.0, 3.0, 4.0])
    v = jnp.array([0.2, 0.3, 0.5])
    want = sps.dirichlet(np.asarray(conc)).logpdf(np.asarray(v))
    np.testing.assert_allclose(
        float(g.dirichlet.logpdf(v, conc)), want, rtol=1e-5
    )


def test_multinomial_and_dirichlet_multinomial():
    logits = jnp.log(jnp.array([0.2, 0.3, 0.5]))
    v = jnp.array([2.0, 3.0, 5.0])
    want = sps.multinomial(10, [0.2, 0.3, 0.5]).logpmf([2, 3, 5])
    np.testing.assert_allclose(
        float(g.multinomial.logpdf(v, 10.0, logits)), want, rtol=1e-5
    )
    conc = jnp.array([1.0, 2.0, 3.0])
    want_dm = sps.dirichlet_multinomial(np.asarray(conc), 10).logpmf([2, 3, 5])
    np.testing.assert_allclose(
        float(g.dirichlet_multinomial.logpdf(v, 10.0, conc)),
        want_dm,
        rtol=1e-5,
    )


def test_beta_binomial():
    want = sps.betabinom(10, 2.0, 3.0).logpmf(4)
    np.testing.assert_allclose(
        float(g.beta_binomial.logpdf(4.0, 10.0, 2.0, 3.0)), want, rtol=1e-5
    )


def test_distribution_gfi():
    """ExactDensity implements the GFI: simulate/assess/generate agree."""
    tr = g.normal.simulate(KEY, (0.5, 2.0))
    score, v = g.normal.assess(tr.get_choices(), (0.5, 2.0))
    assert jnp.allclose(score, tr.get_score())
    tr2, w = g.normal.generate(KEY, g.ChoiceMap.choice(1.0), (0.5, 2.0))
    assert jnp.allclose(w, tr2.get_score())
    assert jnp.allclose(tr2.get_retval(), 1.0)


def test_distribution_masked_constraint():
    """Masked constraints with traced flags select constrain-vs-sample."""
    c = g.ChoiceMap.choice(g.Mask(1.0, jnp.asarray(True)))
    tr, w = g.normal.generate(KEY, c, (0.0, 1.0))
    assert jnp.allclose(tr.get_retval(), 1.0)
    assert jnp.allclose(w, tr.get_score())
    c_f = g.ChoiceMap.choice(g.Mask(1.0, jnp.asarray(False)))
    tr_f, w_f = g.normal.generate(KEY, c_f, (0.0, 1.0))
    assert jnp.allclose(w_f, 0.0)


class TestSupportMetadata:
    """Declared support specs must be honest: samples always land inside
    (a wrong annotation would silently corrupt transforms="auto")."""

    CASES = [
        ("gamma", (2.0, 1.5)),
        ("exponential", (0.7,)),
        ("beta", (2.0, 3.0)),
        ("chi", (3.0,)),
        ("chi2", (3.0,)),
        ("weibull", (1.5, 2.0)),
        ("inverse_gamma", (2.0, 1.0)),
        ("inverse_gaussian", (1.0, 2.0)),
        ("log_normal", (0.0, 1.0)),
        ("logit_normal", (0.0, 1.0)),
        ("half_cauchy", (0.0, 1.0)),
        ("half_normal", (1.0,)),
        ("half_student_t", (3.0, 0.0, 1.0)),
        ("kumaraswamy", (2.0, 2.0)),
        ("beta_quotient", (2.0, 2.0, 2.0, 2.0)),
        ("uniform", (-1.5, 2.5)),
        ("truncated_normal", (0.0, 1.0, -0.5, 1.5)),
        ("truncated_cauchy", (0.0, 1.0, -0.5, 1.5)),
        ("dirichlet", (jnp.array([1.0, 2.0, 3.0]),)),
    ]

    def test_samples_inside_declared_support(self):
        import genjax_xla as g

        for name, args in self.CASES:
            dist = getattr(g, name)
            spec = dist.get_support(*args)
            assert spec is not None, name
            vs = jax.vmap(lambda k: dist.sample(k, *args))(
                jax.random.split(KEY, 200)
            )
            vs = jnp.asarray(vs)
            if spec == "positive":
                assert jnp.all(vs > 0.0), name
            elif spec == "unit_interval":
                assert jnp.all((vs > 0.0) & (vs < 1.0)), name
            elif spec == "simplex":
                assert jnp.allclose(vs.sum(-1), 1.0, atol=1e-5), name
                assert jnp.all(vs >= 0.0), name
            else:
                low, high = spec
                assert jnp.all((vs >= low) & (vs <= high)), name


class TestDistributionKwargs:
    """Named distribution parameters (parity: reference
    ``test_distribution_kwargs`` / ``test_using_primitive_distributions``
    kwarg spellings)."""

    def test_kwargs_equal_positional_bitwise(self):
        @g.gen
        def m_kw():
            return g.normal(loc=1.0, scale=2.0) @ "x"

        @g.gen
        def m_pos():
            return g.normal(1.0, 2.0) @ "x"

        t1 = m_kw.simulate(KEY, ())
        t2 = m_pos.simulate(KEY, ())
        assert float(t1.get_choices()["x"]) == float(t2.get_choices()["x"])
        assert float(t1.get_score()) == float(t2.get_score())

    def test_probs_aliases_exact(self):
        @g.gen
        def mc():
            return g.categorical(probs=jnp.array([0.3, 0.7])) @ "c"

        sc, _ = mc.assess(g.C["c"].set(1), ())
        assert jnp.allclose(sc, jnp.log(0.7), atol=1e-6)

        @g.gen
        def mb():
            return g.bernoulli(probs=0.4) @ "b"

        sc, _ = mb.assess(g.C["b"].set(True), ())
        assert jnp.allclose(sc, jnp.log(0.4), atol=1e-6)

    def test_bad_kwargs_rejected(self):
        @g.gen
        def dup():
            return g.normal(0.0, loc=1.0, scale=2.0) @ "x"

        with pytest.raises(TypeError, match="positionally and by name"):
            dup.simulate(KEY, ())

        @g.gen
        def typo():
            return g.normal(loc=1.0, scales=2.0) @ "x"

        with pytest.raises(TypeError, match="missing parameter"):
            typo.simulate(KEY, ())

    def test_kwargs_compose_with_sample_shape(self):
        @g.gen
        def ms():
            return g.normal(
                loc=0.0, scale=1.0, sample_shape=g.Const((4,))
            ) @ "x"

        tr = ms.simulate(KEY, ())
        assert tr.get_retval().shape == (4,)
