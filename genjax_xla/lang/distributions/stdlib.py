"""The distribution standard library: samplers + log-densities implemented
directly on ``jax.random`` / ``jnp`` / ``jax.scipy`` — no TensorFlow
Probability dependency.

Functional parity target: the ~45 TFP wrappers at
``/root/reference/src/genjax/_src/generative_functions/distributions/
tensorflow_probability/__init__.py:72-317``. Parameterizations follow the
reference (i.e. TFP conventions): ``bernoulli`` takes logits, ``flip`` takes
probs, ``categorical`` takes logits, ``gamma`` takes (concentration, rate),
``inverse_gamma`` (concentration, scale), etc.

Every sampler is jit-traceable with static shapes (rejection samplers use
bounded ``lax.while_loop``), so models compose with ``vmap`` / ``scan`` /
``shard_map``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import jax.random as jr
import jax.scipy.special as jsp
import jax.scipy.stats as jss
from jax import lax

from genjax_xla.lang.distributions.distribution import exact_density

__all__ = [
    "bernoulli", "beta", "beta_binomial", "beta_quotient", "binomial",
    "categorical", "lambert_w_normal", "power_spherical",
    "von_mises_fisher",
    "cauchy", "chi", "chi2", "dirichlet", "dirichlet_multinomial",
    "double_sided_maxwell", "exp_gamma", "exp_inverse_gamma", "exponential",
    "flip", "gamma", "geometric", "gumbel", "half_cauchy", "half_normal",
    "half_student_t", "inverse_gamma", "inverse_gaussian", "kumaraswamy",
    "laplace", "log_normal", "logistic", "logit_normal", "moyal",
    "multinomial",
    "mv_normal", "mv_normal_diag", "negative_binomial", "non_central_chi2",
    "normal", "poisson", "skellam", "student_t", "truncated_cauchy",
    "truncated_normal", "uniform", "von_mises", "weibull", "zipf",
]

_f = lambda x: jnp.asarray(x, dtype=jnp.result_type(float))


# ---------------------------------------------------------------------------
# Continuous, location-scale & friends
# ---------------------------------------------------------------------------

def _bshape(*args):
    return jnp.broadcast_shapes(*(jnp.shape(a) for a in args))


def _normal_sample(key, loc, scale):
    return loc + scale * jr.normal(key, _bshape(loc, scale))


#: Normal(loc, scale). Reference `tensorflow_probability/__init__.py:252`.
normal = exact_density(_normal_sample, jss.norm.logpdf, "normal")

#: Cauchy(loc, scale).
cauchy = exact_density(
    lambda key, loc, scale: loc + scale * jr.cauchy(key, _bshape(loc, scale)),
    jss.cauchy.logpdf,
    "cauchy",
)

#: Laplace(loc, scale).
laplace = exact_density(
    lambda key, loc, scale: loc + scale * jr.laplace(key, _bshape(loc, scale)),
    jss.laplace.logpdf,
    "laplace",
)

#: Logistic(loc, scale).
logistic = exact_density(
    lambda key, loc, scale: loc
    + scale * jr.logistic(key, _bshape(loc, scale)),
    jss.logistic.logpdf,
    "logistic",
)

#: Gumbel(loc, scale) (max-Gumbel, TFP convention).
gumbel = exact_density(
    lambda key, loc, scale: loc + scale * jr.gumbel(key, _bshape(loc, scale)),
    jss.gumbel_r.logpdf,
    "gumbel",
)

#: StudentT(df, loc, scale).
student_t = exact_density(
    lambda key, df, loc, scale: loc
    + scale * jr.t(key, df, _bshape(df, loc, scale)),
    lambda v, df, loc, scale: jss.t.logpdf(v, df, loc, scale),
    "student_t",
)


def _half_student_t_sample(key, df, loc, scale):
    return loc + scale * jnp.abs(jr.t(key, df, _bshape(df, loc, scale)))


def _half_student_t_logpdf(v, df, loc, scale):
    lp = jnp.log(2.0) + jss.t.logpdf(v, df, loc, scale)
    return jnp.where(v >= loc, lp, -jnp.inf)


#: HalfStudentT(df, loc, scale).
half_student_t = exact_density(
    _half_student_t_sample, _half_student_t_logpdf, "half_student_t",
    support="positive",
)


def _half_cauchy_logpdf(v, loc, scale):
    lp = jnp.log(2.0) + jss.cauchy.logpdf(v, loc, scale)
    return jnp.where(v >= loc, lp, -jnp.inf)


#: HalfCauchy(loc, scale).
half_cauchy = exact_density(
    lambda key, loc, scale: loc
    + scale * jnp.abs(jr.cauchy(key, _bshape(loc, scale))),
    _half_cauchy_logpdf,
    "half_cauchy",
    support="positive",
)


def _half_normal_logpdf(v, scale):
    lp = jnp.log(2.0) + jss.norm.logpdf(v, 0.0, scale)
    return jnp.where(v >= 0.0, lp, -jnp.inf)


#: HalfNormal(scale).
half_normal = exact_density(
    lambda key, scale: scale * jnp.abs(jr.normal(key, jnp.shape(scale))),
    _half_normal_logpdf,
    "half_normal",
    support="positive",
)

#: LogNormal(loc, scale) — exp of Normal(loc, scale).
log_normal = exact_density(
    lambda key, loc, scale: jnp.exp(_normal_sample(key, loc, scale)),
    lambda v, loc, scale: jss.norm.logpdf(jnp.log(v), loc, scale)
    - jnp.log(v),
    "log_normal",
    support="positive",
)

#: LogitNormal(loc, scale) — sigmoid of Normal(loc, scale).
logit_normal = exact_density(
    lambda key, loc, scale: jax.nn.sigmoid(_normal_sample(key, loc, scale)),
    lambda v, loc, scale: jss.norm.logpdf(jsp.logit(v), loc, scale)
    - jnp.log(v) - jnp.log1p(-v),
    "logit_normal",
    support="unit_interval",
)

#: Uniform(low, high).
uniform = exact_density(
    lambda key, low=0.0, high=1.0: jr.uniform(
        key, _bshape(low, high), minval=low, maxval=high
    ),
    lambda v, low=0.0, high=1.0: jss.uniform.logpdf(v, low, high - low),
    "uniform",
    support=lambda low=0.0, high=1.0: (low, high),
)

#: Exponential(rate).
exponential = exact_density(
    lambda key, rate: jr.exponential(key, jnp.shape(rate)) / rate,
    lambda v, rate: jss.expon.logpdf(v, scale=1.0 / rate),
    "exponential",
    support="positive",
)

#: Beta(concentration1, concentration0).
beta = exact_density(
    lambda key, c1, c0: jr.beta(key, c1, c0, _bshape(c1, c0)),
    jss.beta.logpdf,
    "beta",
    support="unit_interval",
)

#: Gamma(concentration, rate) — TFP rate convention.
gamma = exact_density(
    lambda key, conc, rate: jr.gamma(key, conc, _bshape(conc, rate)) / rate,
    lambda v, conc, rate: jss.gamma.logpdf(v, conc, scale=1.0 / rate),
    "gamma",
    support="positive",
)


def _inverse_gamma_logpdf(v, conc, scale):
    return (conc * jnp.log(scale) - jsp.gammaln(conc)
            - (conc + 1.0) * jnp.log(v) - scale / v)


#: InverseGamma(concentration, scale): 1/X where X ~ Gamma(conc, rate=scale).
inverse_gamma = exact_density(
    lambda key, conc, scale: scale / jr.gamma(key, conc, _bshape(conc, scale)),
    _inverse_gamma_logpdf,
    "inverse_gamma",
    support="positive",
)


def _exp_gamma_logpdf(y, conc, rate=1.0):
    # Y = log X, X ~ Gamma(conc, rate).
    return (conc * jnp.log(rate) - jsp.gammaln(conc) + conc * y
            - rate * jnp.exp(y))


#: ExpGamma(concentration, rate): log of Gamma — underflow-safe via loggamma.
exp_gamma = exact_density(
    lambda key, conc, rate=1.0: jr.loggamma(key, conc, _bshape(conc, rate))
    - jnp.log(rate),
    _exp_gamma_logpdf,
    "exp_gamma",
)


def _exp_inverse_gamma_logpdf(y, conc, scale=1.0):
    # Y = log X, X ~ InverseGamma(conc, scale) = -log Gamma(conc, rate=scale).
    return (conc * jnp.log(scale) - jsp.gammaln(conc) - conc * y
            - scale * jnp.exp(-y))


#: ExpInverseGamma(concentration, scale).
exp_inverse_gamma = exact_density(
    lambda key, conc, scale=1.0: jnp.log(scale)
    - jr.loggamma(key, conc, _bshape(conc, scale)),
    _exp_inverse_gamma_logpdf,
    "exp_inverse_gamma",
)

#: Chi2(df).
chi2 = exact_density(
    lambda key, df: jr.chisquare(key, df, jnp.shape(df)),
    jss.chi2.logpdf,
    "chi2",
    support="positive",
)


def _chi_logpdf(v, df):
    return ((df - 1.0) * jnp.log(v) - v * v / 2.0
            - (df / 2.0 - 1.0) * jnp.log(2.0) - jsp.gammaln(df / 2.0))


#: Chi(df) — sqrt of Chi2(df).
chi = exact_density(
    lambda key, df: jnp.sqrt(jr.chisquare(key, df, jnp.shape(df))),
    _chi_logpdf,
    "chi",
    support="positive",
)


def _weibull_logpdf(v, conc, scale):
    z = v / scale
    return (jnp.log(conc) - jnp.log(scale) + (conc - 1.0) * jnp.log(z)
            - z**conc)


#: Weibull(concentration, scale) — TFP convention.
weibull = exact_density(
    lambda key, conc, scale: scale
    * jr.weibull_min(key, 1.0, conc, _bshape(conc, scale)),
    _weibull_logpdf,
    "weibull",
    support="positive",
)


def _kumaraswamy_logpdf(v, a, b):
    return (jnp.log(a) + jnp.log(b) + (a - 1.0) * jnp.log(v)
            + (b - 1.0) * jnp.log1p(-(v**a)))


#: Kumaraswamy(concentration1, concentration0) — inverse-CDF sampling.
kumaraswamy = exact_density(
    lambda key, a, b: (
        1.0 - (1.0 - jr.uniform(key, _bshape(a, b))) ** (1.0 / b)
    ) ** (1.0 / a),
    _kumaraswamy_logpdf,
    "kumaraswamy",
    support="unit_interval",
)


def _dsm_logpdf(v, loc, scale):
    z = (v - loc) / scale
    return (2.0 * jnp.log(jnp.abs(z)) - z * z / 2.0
            - 0.5 * jnp.log(2.0 * jnp.pi) - jnp.log(scale))


#: DoubleSidedMaxwell(loc, scale).
double_sided_maxwell = exact_density(
    lambda key, loc, scale: loc
    + scale * jr.double_sided_maxwell(key, 0.0, 1.0, _bshape(loc, scale)),
    _dsm_logpdf,
    "double_sided_maxwell",
)


def _moyal_logpdf(v, loc, scale):
    z = (v - loc) / scale
    return (-0.5 * (z + jnp.exp(-z)) - 0.5 * jnp.log(2.0 * jnp.pi)
            - jnp.log(scale))


def _moyal_sample(key, loc, scale):
    # Inverse CDF: F(z) = erfc(exp(-z/2)/sqrt(2)); z = -log(2 erfinv-based).
    u = jr.uniform(key, _bshape(loc, scale))
    z = -2.0 * jnp.log(jsp.erfinv(1.0 - u) * jnp.sqrt(2.0))
    return loc + scale * z


#: Moyal(loc, scale).
moyal = exact_density(_moyal_sample, _moyal_logpdf, "moyal")


def _truncnorm_sample(key, loc, scale, low, high):
    a = (low - loc) / scale
    b = (high - loc) / scale
    z = jr.truncated_normal(key, a, b, _bshape(loc, scale, low, high))
    return loc + scale * z


def _truncnorm_logpdf(v, loc, scale, low, high):
    a = (low - loc) / scale
    b = (high - loc) / scale
    return jss.truncnorm.logpdf((v - loc) / scale, a, b) - jnp.log(scale)


#: TruncatedNormal(loc, scale, low, high).
truncated_normal = exact_density(
    _truncnorm_sample, _truncnorm_logpdf, "truncated_normal",
    support=lambda loc, scale, low, high: (low, high),
)


def _cauchy_cdf(z):
    return jnp.arctan(z) / jnp.pi + 0.5


def _trunc_cauchy_sample(key, loc, scale, low, high):
    fa = _cauchy_cdf((low - loc) / scale)
    fb = _cauchy_cdf((high - loc) / scale)
    u = jr.uniform(key, _bshape(loc, scale, low, high))
    p = fa + u * (fb - fa)
    return loc + scale * jnp.tan(jnp.pi * (p - 0.5))


def _trunc_cauchy_logpdf(v, loc, scale, low, high):
    fa = _cauchy_cdf((low - loc) / scale)
    fb = _cauchy_cdf((high - loc) / scale)
    lp = jss.cauchy.logpdf(v, loc, scale) - jnp.log(fb - fa)
    return jnp.where((v >= low) & (v <= high), lp, -jnp.inf)


#: TruncatedCauchy(loc, scale, low, high) — inverse-CDF sampling.
truncated_cauchy = exact_density(
    _trunc_cauchy_sample, _trunc_cauchy_logpdf, "truncated_cauchy",
    support=lambda loc, scale, low, high: (low, high),
)


def _inverse_gaussian_sample(key, loc, conc):
    # Michael–Schucany–Haas transform: exact, no rejection loop.
    shape = _bshape(loc, conc)
    k_n, k_u = jr.split(key)
    nu = jr.normal(key=k_n, shape=shape)
    y = nu * nu
    x = (loc + loc * loc * y / (2.0 * conc)
         - loc / (2.0 * conc)
         * jnp.sqrt(4.0 * loc * conc * y + loc * loc * y * y))
    u = jr.uniform(k_u, shape)
    return jnp.where(u <= loc / (loc + x), x, loc * loc / x)


def _inverse_gaussian_logpdf(v, loc, conc):
    return (0.5 * jnp.log(conc / (2.0 * jnp.pi))
            - 1.5 * jnp.log(v)
            - conc * (v - loc) ** 2 / (2.0 * loc * loc * v))


#: InverseGaussian(loc, concentration) — TFP convention.
inverse_gaussian = exact_density(
    _inverse_gaussian_sample, _inverse_gaussian_logpdf, "inverse_gaussian",
    support="positive",
)


def _von_mises_sample(key, loc, conc):
    """Best–Fisher wrapped-Cauchy rejection in a ``lax.while_loop``."""
    shape = _bshape(loc, conc)
    conc = jnp.broadcast_to(_f(conc), shape)
    r = 1.0 + jnp.sqrt(1.0 + 4.0 * conc * conc)
    rho = (r - jnp.sqrt(2.0 * r)) / (2.0 * conc)
    s = (1.0 + rho * rho) / (2.0 * rho)

    def body(state):
        key, _, done, out = state
        key, k1, k2, k3 = jr.split(key, 4)
        u1 = jr.uniform(k1, shape)
        u2 = jr.uniform(k2, shape)
        u3 = jr.uniform(k3, shape)
        z = jnp.cos(jnp.pi * u1)
        f = (1.0 + s * z) / (s + z)
        c = conc * (s - f)
        accept = (c * (2.0 - c) - u2 > 0.0) | (jnp.log(c / u2) + 1.0 - c >= 0.0)
        val = jnp.sign(u3 - 0.5) * jnp.arccos(jnp.clip(f, -1.0, 1.0))
        out = jnp.where(done, out, jnp.where(accept, val, out))
        done = done | accept
        return key, jnp.all(done), done, out

    init = (key, jnp.asarray(False), jnp.zeros(shape, bool),
            jnp.zeros(shape, jnp.result_type(float)))
    _, _, _, theta = lax.while_loop(lambda st: ~st[1], body, init)
    return jnp.mod(theta + loc + jnp.pi, 2.0 * jnp.pi) - jnp.pi


def _von_mises_logpdf(v, loc, conc):
    return conc * jnp.cos(v - loc) - jnp.log(2.0 * jnp.pi) - jnp.log(
        jsp.i0e(conc)
    ) - conc


#: VonMises(loc, concentration).
von_mises = exact_density(_von_mises_sample, _von_mises_logpdf, "von_mises")


# ---------------------------------------------------------------------------
# Discrete
# ---------------------------------------------------------------------------


def _bernoulli_logits_logpmf(v, logits):
    v = _f(v)
    return v * logits - jnp.logaddexp(0.0, logits)


#: Bernoulli(logits) — TFP logits convention
#: (reference `tensorflow_probability/__init__.py:84`).
bernoulli = exact_density(
    lambda key, logits: jr.bernoulli(key, jax.nn.sigmoid(logits)),
    _bernoulli_logits_logpmf,
    "bernoulli",
    aliases={"probs": ("logits", lambda p: jsp.logit(_f(p)))},
)


def _flip_logpmf(v, p):
    v = _f(v)
    return jsp.xlogy(v, p) + jsp.xlog1py(1.0 - v, -p)


#: Flip(prob) — probability-parameterized Bernoulli
#: (reference `tensorflow_probability/__init__.py:155`).
flip = exact_density(
    lambda key, p: jr.bernoulli(key, p, jnp.shape(p)),
    _flip_logpmf,
    "flip",
)


def _categorical_logpmf(v, logits):
    logits = _f(logits)
    logz = jsp.logsumexp(logits, axis=-1)
    picked = jnp.take_along_axis(
        logits, jnp.asarray(v, jnp.int32)[..., None], axis=-1
    )[..., 0]
    return picked - logz


#: Categorical(logits).
categorical = exact_density(
    lambda key, logits: jr.categorical(key, logits),
    _categorical_logpmf,
    "categorical",
    aliases={"probs": ("logits", lambda p: jnp.log(_f(p)))},
)

#: Poisson(rate).
poisson = exact_density(
    lambda key, rate: jr.poisson(key, rate, jnp.shape(rate)),
    jss.poisson.logpmf,
    "poisson",
)


def _geometric_logpmf(v, p):
    # TFP convention: k failures before the first success, support {0,1,...}.
    return jsp.xlog1py(_f(v), -p) + jnp.log(p)


#: Geometric(probs) — failures before first success.
geometric = exact_density(
    lambda key, p: jnp.floor(
        jnp.log1p(-jr.uniform(key, jnp.shape(p))) / jnp.log1p(-p)
    ).astype(jnp.int32),
    _geometric_logpmf,
    "geometric",
)


def _binomial_logpmf(v, n, p):
    return jss.binom.logpmf(v, n, p)


#: Binomial(total_count, probs).
binomial = exact_density(
    lambda key, n, p: jr.binomial(key, n, p, shape=_bshape(n, p)),
    _binomial_logpmf,
    "binomial",
)


def _beta_binomial_logpmf(v, n, c1, c0):
    return jss.betabinom.logpmf(v, n, c1, c0)


def _beta_binomial_sample(key, n, c1, c0):
    k1, k2 = jr.split(key)
    p = jr.beta(k1, c1, c0, _bshape(n, c1, c0))
    return jr.binomial(k2, n, p)


#: BetaBinomial(total_count, concentration1, concentration0).
beta_binomial = exact_density(
    _beta_binomial_sample, _beta_binomial_logpmf, "beta_binomial"
)


def _negative_binomial_sample(key, n, p):
    # Gamma–Poisson mixture; p = per-trial success prob of counted events
    # (TFP convention: pmf(k) ∝ p^k (1-p)^n).
    k1, k2 = jr.split(key)
    lam = jr.gamma(k1, n, _bshape(n, p)) * p / (1.0 - p)
    return jr.poisson(k2, lam)


def _negative_binomial_logpmf(v, n, p):
    v = _f(v)
    return (jsp.gammaln(v + n) - jsp.gammaln(n) - jsp.gammaln(v + 1.0)
            + jsp.xlogy(v, p) + jsp.xlog1py(n, -p))


#: NegativeBinomial(total_count, probs) — TFP convention.
negative_binomial = exact_density(
    _negative_binomial_sample, _negative_binomial_logpmf, "negative_binomial"
)


def _nc_chi2_sample(key, df, nc):
    # X = Chi2(df-1) + (Z + sqrt(nc))^2 for df > 1; Poisson-mixture for
    # general df: X ~ Chi2(df + 2K), K ~ Poisson(nc/2).
    k1, k2 = jr.split(key)
    kk = jr.poisson(k1, nc / 2.0, _bshape(df, nc))
    return jr.chisquare(k2, df + 2.0 * kk)


def _nc_chi2_logpdf(v, df, nc):
    # log f = log sum_k Pois(k; nc/2) chi2(v; df+2k): use the standard
    # closed form with the modified Bessel function via series (stable for
    # moderate nc): fall back to the Poisson-weighted logsumexp over a
    # truncated series.
    ks = jnp.arange(64.0)
    logw = jss.poisson.logpmf(ks, nc / 2.0)
    lp = jss.chi2.logpdf(v[..., None] if jnp.ndim(v) else v, df + 2.0 * ks)
    return jsp.logsumexp(logw + lp, axis=-1)


#: NonCentralChi2(df, noncentrality) — Poisson-mixture representation.
non_central_chi2 = exact_density(
    _nc_chi2_sample, _nc_chi2_logpdf, "non_central_chi2"
)


def _skellam_logpmf(v, mu1, mu2):
    # pmf(k) = e^{-(mu1+mu2)} (mu1/mu2)^{k/2} I_|k|(2 sqrt(mu1 mu2));
    # evaluated via Poisson-convolution logsumexp (stable, bounded series).
    v = jnp.asarray(v)
    ks = jnp.arange(128.0)
    lp = (jss.poisson.logpmf(ks + jnp.maximum(_f(v), 0.0), mu1)
          + jss.poisson.logpmf(ks + jnp.maximum(-_f(v), 0.0), mu2))
    return jsp.logsumexp(lp, axis=-1)


def _skellam_sample(key, mu1, mu2):
    k1, k2 = jr.split(key)
    shape = _bshape(mu1, mu2)
    return (jr.poisson(k1, mu1, shape) - jr.poisson(k2, mu2, shape)).astype(
        jnp.int32
    )


#: Skellam(rate1, rate2) — difference of independent Poissons.
skellam = exact_density(_skellam_sample, _skellam_logpmf, "skellam")


def _zipf_logpmf(v, power):
    # pmf(k) = k^-power / zeta(power), k >= 1.
    return -power * jnp.log(_f(v)) - jnp.log(jsp.zeta(power, 1.0))


def _zipf_sample(key, power):
    # Devroye's rejection-inversion, bounded while_loop.
    shape = jnp.shape(power)
    b = 2.0 ** (power - 1.0)

    def body(state):
        key, _, done, out = state
        key, k1, k2 = jr.split(key, 3)
        u = jr.uniform(k1, shape)
        v = jr.uniform(k2, shape)
        x = jnp.floor(u ** (-1.0 / (power - 1.0)))
        t = (1.0 + 1.0 / x) ** (power - 1.0)
        accept = (x >= 1.0) & (v * x * (t - 1.0) / (b - 1.0) <= t / b)
        out = jnp.where(done, out, jnp.where(accept, x, out))
        done = done | accept
        return key, jnp.all(done), done, out

    init = (key, jnp.asarray(False), jnp.zeros(shape, bool),
            jnp.ones(shape, jnp.result_type(float)))
    _, _, _, x = lax.while_loop(lambda st: ~st[1], body, init)
    return x.astype(jnp.int32)


#: Zipf(power), power > 1, support {1, 2, ...}.
zipf = exact_density(_zipf_sample, _zipf_logpmf, "zipf")


# ---------------------------------------------------------------------------
# Multivariate
# ---------------------------------------------------------------------------


def _mvn_diag_sample(key, loc, scale_diag):
    shape = _bshape(loc, scale_diag)
    return loc + scale_diag * jr.normal(key, shape)


def _mvn_diag_logpdf(v, loc, scale_diag):
    return jnp.sum(jss.norm.logpdf(v, loc, scale_diag), axis=-1)


#: MultivariateNormalDiag(loc, scale_diag).
mv_normal_diag = exact_density(
    _mvn_diag_sample, _mvn_diag_logpdf, "mv_normal_diag"
)

#: MultivariateNormalFullCovariance(loc, covariance_matrix).
mv_normal = exact_density(
    lambda key, loc, cov: jr.multivariate_normal(key, loc, cov),
    jss.multivariate_normal.logpdf,
    "mv_normal",
)

#: Dirichlet(concentration).
dirichlet = exact_density(
    lambda key, conc: jr.dirichlet(key, conc),
    jss.dirichlet.logpdf,
    "dirichlet",
    support="simplex",
)


def _multinomial_logpmf(v, n, logits):
    v = _f(v)
    logp = jax.nn.log_softmax(logits, axis=-1)
    return (jsp.gammaln(_f(n) + 1.0)
            - jnp.sum(jsp.gammaln(v + 1.0), axis=-1)
            + jnp.sum(v * logp, axis=-1))


#: Multinomial(total_count, logits).
multinomial = exact_density(
    lambda key, n, logits: jr.multinomial(
        key, n, jax.nn.softmax(logits, axis=-1)
    ),
    _multinomial_logpmf,
    "multinomial",
)


def _dirichlet_multinomial_sample(key, n, conc):
    k1, k2 = jr.split(key)
    p = jr.dirichlet(k1, conc)
    return jr.multinomial(k2, n, p)


def _dirichlet_multinomial_logpmf(v, n, conc):
    v = _f(v)
    c = _f(conc)
    c0 = jnp.sum(c, axis=-1)
    return (jsp.gammaln(_f(n) + 1.0) + jsp.gammaln(c0)
            - jsp.gammaln(_f(n) + c0)
            + jnp.sum(
                jsp.gammaln(v + c) - jsp.gammaln(v + 1.0) - jsp.gammaln(c),
                axis=-1,
            ))


#: DirichletMultinomial(total_count, concentration).
dirichlet_multinomial = exact_density(
    _dirichlet_multinomial_sample,
    _dirichlet_multinomial_logpmf,
    "dirichlet_multinomial",
)


# ---------------------------------------------------------------------------
# Long-tail distributions (parity: the remaining TFP wrappers at reference
# `tensorflow_probability/__init__.py`: beta_quotient, lambert_w_normal,
# power_spherical, von_mises_fisher)
# ---------------------------------------------------------------------------


def _beta_quotient_sample(key, a1, b1, a2, b2):
    k1, k2 = jr.split(key)
    shape = _bshape(a1, b1, a2, b2)
    x = jr.beta(k1, a1, b1, shape)
    y = jr.beta(k2, a2, b2, shape)
    return x / y


def _beta_quotient_logpdf(t, a1, b1, a2, b2):
    # Density of X/Y, X~Beta(a1,b1), Y~Beta(a2,b2) (Pham-Gia 2000):
    #   t<=1: B(a1+a2,b1) t^(a1-1) 2F1(a1+a2, 1-b2; a1+a2+b1; t) / Z
    #   t>=1: B(a1+a2,b2) t^-(a2+1) 2F1(a1+a2, 1-b2; a1+a2+b1; 1/t)... by
    # the X/Y <-> Y/X symmetry; Z = B(a1,b1) B(a2,b2).
    t = _f(t)

    def logB(a, b):
        return jsp.gammaln(a) + jsp.gammaln(b) - jsp.gammaln(a + b)

    logZ = logB(a1, b1) + logB(a2, b2)
    t_lo = jnp.minimum(t, 1.0)
    lo = (
        logB(a1 + a2, b1)
        + (a1 - 1.0) * jnp.log(t_lo)
        + jnp.log(jsp.hyp2f1(a1 + a2, 1.0 - b2, a1 + a2 + b1, t_lo))
        - logZ
    )
    # t > 1: density of T = X/Y at t equals density of Y/X at 1/t times
    # 1/t^2.
    s = jnp.minimum(1.0 / jnp.maximum(t, 1.0), 1.0)
    hi = (
        logB(a2 + a1, b2)
        + (a2 - 1.0) * jnp.log(s)
        + jnp.log(jsp.hyp2f1(a2 + a1, 1.0 - b1, a2 + a1 + b2, s))
        - logZ
        - 2.0 * jnp.log(jnp.maximum(t, 1.0))
    )
    return jnp.where(t <= 1.0, lo, hi)


#: BetaQuotient(a1, b1, a2, b2) — ratio of independent Betas.
beta_quotient = exact_density(
    _beta_quotient_sample, _beta_quotient_logpdf, "beta_quotient",
    support="positive",
)


def _lambert_w_normal_sample(key, loc, scale, tailweight):
    from genjax_xla.lang.distributions.special import lambertw  # noqa: F401

    u = jr.normal(key, _bshape(loc, scale, tailweight))
    z = u * jnp.exp(tailweight * u * u / 2.0)
    return loc + scale * z


def _lambert_w_normal_logpdf(y, loc, scale, tailweight):
    from genjax_xla.lang.distributions.special import lambertw

    z = (y - loc) / scale
    d = tailweight
    # Inverse transform: u = sign(z) sqrt(W(d z^2)/d); dz/du = e^{du²/2}(1+du²)
    w = lambertw(d * z * z)
    u = jnp.sign(z) * jnp.sqrt(jnp.maximum(w / jnp.maximum(d, 1e-12), 0.0))
    u = jnp.where(d == 0.0, z, u)
    jac = jnp.exp(d * u * u / 2.0) * (1.0 + d * u * u)
    return (jss.norm.logpdf(u) - jnp.log(jnp.maximum(jac, 1e-30))
            - jnp.log(scale))


#: LambertWNormal(loc, scale, tailweight) — heavy-tailed Gaussian via the
#: Lambert W x Gaussian transform (Goerg 2011).
lambert_w_normal = exact_density(
    _lambert_w_normal_sample, _lambert_w_normal_logpdf, "lambert_w_normal"
)


def _householder_rotate(y, mu):
    """Map e1-aligned samples to mu-aligned via Householder reflection."""
    d = mu.shape[-1]
    e1 = jnp.zeros(d).at[0].set(1.0)
    u = e1 - mu
    norm = jnp.linalg.norm(u)
    u = jnp.where(norm > 1e-9, u / jnp.maximum(norm, 1e-9), u)
    return jnp.where(norm > 1e-9, y - 2.0 * jnp.dot(u, y) * u, y)


def _power_spherical_sample(key, mu, conc):
    # De Cao & Aziz 2020: exact sampling via a transformed Beta.
    d = mu.shape[-1]
    alpha = (d - 1.0) / 2.0 + conc
    beta_ = (d - 1.0) / 2.0
    k1, k2 = jr.split(key)
    b = jr.beta(k1, alpha, beta_)
    t = 2.0 * b - 1.0
    v = jr.normal(k2, (d - 1,))
    v = v / jnp.maximum(jnp.linalg.norm(v), 1e-12)
    y = jnp.concatenate([t[None], jnp.sqrt(1.0 - t * t) * v])
    return _householder_rotate(y, mu)


def _power_spherical_logpdf(x, mu, conc):
    d = mu.shape[-1]
    alpha = (d - 1.0) / 2.0 + conc
    beta_ = (d - 1.0) / 2.0
    log_c = -(
        (alpha + beta_) * jnp.log(2.0)
        + jsp.gammaln(alpha)
        - jsp.gammaln(alpha + beta_)
        + beta_ * jnp.log(jnp.pi)
    )
    return log_c + conc * jnp.log1p(jnp.sum(mu * x, axis=-1))


#: PowerSpherical(mean_direction, concentration) on S^{d-1}.
power_spherical = exact_density(
    _power_spherical_sample, _power_spherical_logpdf, "power_spherical"
)


def _vmf_sample(key, mu, conc):
    """von Mises-Fisher via Wood (1994) rejection on the first coordinate,
    bounded lax.while_loop; then Householder rotation."""
    d = mu.shape[-1]
    k_w, k_v = jr.split(key)
    b = (-2.0 * conc + jnp.sqrt(4.0 * conc * conc + (d - 1.0) ** 2)) / (
        d - 1.0
    )
    x0 = (1.0 - b) / (1.0 + b)
    c = conc * x0 + (d - 1.0) * jnp.log(1.0 - x0 * x0)

    def body(state):
        key, _, done, w = state
        key, kz, ku = jr.split(key, 3)
        z = jr.beta(kz, (d - 1.0) / 2.0, (d - 1.0) / 2.0)
        u = jr.uniform(ku, ())
        w_prop = (1.0 - (1.0 + b) * z) / (1.0 - (1.0 - b) * z)
        accept = conc * w_prop + (d - 1.0) * jnp.log(
            jnp.maximum(1.0 - x0 * w_prop, 1e-30)
        ) - c >= jnp.log(u)
        w = jnp.where(done, w, jnp.where(accept, w_prop, w))
        done = done | accept
        return key, done, done, w

    _, _, _, w = lax.while_loop(
        lambda st: ~st[1],
        body,
        (k_w, jnp.asarray(False), jnp.asarray(False), jnp.zeros(())),
    )
    v = jr.normal(k_v, (d - 1,))
    v = v / jnp.maximum(jnp.linalg.norm(v), 1e-12)
    y = jnp.concatenate([w[None], jnp.sqrt(1.0 - w * w) * v])
    return _householder_rotate(y, mu)


def _vmf_logpdf(x, mu, conc):
    from genjax_xla.lang.distributions.special import log_bessel_iv

    d = mu.shape[-1]
    nu = d / 2.0 - 1.0
    log_c = (
        nu * jnp.log(jnp.maximum(conc, 1e-30))
        - (d / 2.0) * jnp.log(2.0 * jnp.pi)
        - log_bessel_iv(nu, conc)
    )
    return log_c + conc * jnp.sum(mu * x, axis=-1)


#: VonMisesFisher(mean_direction, concentration) on S^{d-1}.
von_mises_fisher = exact_density(_vmf_sample, _vmf_logpdf, "von_mises_fisher")
