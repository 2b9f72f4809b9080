"""ADEV gradient-strategy primitives: score-function (REINFORCE), exact
enumeration, measure-valued derivatives, reparameterization, and variance
reduction — all on jax.random samplers (no TFP).

Parity target: ``/root/reference/src/genjax/_src/adev/primitives.py``
(``REINFORCE`` :77, ``FlipEnum`` :116, ``FlipMVD`` :156, ``FlipEnumParallel``
:183, ``CategoricalEnumParallel`` :220, reparam prims :271-390,
``BetaIMPLICIT`` :392, ``Baseline`` :423, ``AddCost`` :479, instances
:255-268).
"""

from __future__ import annotations

from typing import Any, Callable

import jax
import jax.numpy as jnp
import jax.random as jr
import jax.scipy.special as jsp
import jax.scipy.stats as jss

from genjax_xla.core.pytree import Pytree
from genjax_xla.adev.core import ADEVPrimitive, Dual, TailCallADEVPrimitive

__all__ = [
    "REINFORCE",
    "reinforce",
    "FlipEnum",
    "FlipEnumParallel",
    "FlipMVD",
    "CategoricalEnumParallel",
    "NormalREPARAM",
    "MvNormalDiagREPARAM",
    "MvNormalREPARAM",
    "UniformREPARAM",
    "BetaIMPLICIT",
    "GammaIMPLICIT",
    "DirichletIMPLICIT",
    "Baseline",
    "baseline",
    "AddCost",
    "add_cost",
    "flip_enum",
    "flip_enum_parallel",
    "flip_mvd",
    "flip_reinforce",
    "categorical_enum_parallel",
    "geometric_reinforce",
    "normal_reinforce",
    "normal_reparam",
    "mv_normal_diag_reparam",
    "mv_normal_reparam",
    "uniform",
    "beta_implicit",
    "gamma_implicit",
    "dirichlet_implicit",
]


@Pytree.dataclass
class REINFORCE(ADEVPrimitive):
    """Score-function estimator: ∇E[f] ≈ ∇f + f·∇log p.

    Parity: reference ``primitives.py:77-108``."""

    sample_function: Callable = Pytree.static()
    differentiable_logpdf: Callable = Pytree.static()

    def sample(self, key, *args):
        return self.sample_function(key, *args)

    def jvp_estimate(self, key, dual_args, konts):
        _, kdual = konts
        primals = Dual.tree_primal(dual_args)
        tangents = Dual.tree_tangent(dual_args)
        key, sub_key = jax.random.split(key)
        v = self.sample(sub_key, *primals)
        out_dual = kdual(key, Dual.tree_pure(v))
        (out_primal,), (out_tangent,) = Dual.tree_unzip(out_dual)
        # Score-function term differentiates log p(v; params) w.r.t. the
        # params only (v is held fixed — valid for discrete and continuous).
        _, lp_tangent = jax.jvp(
            lambda *params: self.differentiable_logpdf(v, *params),
            tuple(primals),
            tuple(tangents),
        )
        return Dual(out_primal, out_tangent + out_primal * lp_tangent)


def reinforce(sample_func, logpdf_func) -> REINFORCE:
    return REINFORCE(sample_func, logpdf_func)


@Pytree.dataclass
class FlipEnum(ADEVPrimitive):
    """Exact enumeration over {True, False}. Parity: reference
    ``primitives.py:116-153``."""

    def sample(self, key, p):
        return jr.bernoulli(key, p)

    def enum_support(self, p):
        return jnp.array([True, False])

    def enum_probs(self, p):
        return jnp.stack([p, 1.0 - p])

    def jvp_estimate(self, key, dual_args, konts):
        _, kdual = konts
        (p_dual,) = dual_args
        p, p_tan = p_dual.primal, p_dual.tangent
        true_dual = kdual(key, Dual.tree_pure(jnp.asarray(True)))
        false_dual = kdual(key, Dual.tree_pure(jnp.asarray(False)))
        (tp,), (tt,) = Dual.tree_unzip(true_dual)
        (fp,), (ft,) = Dual.tree_unzip(false_dual)
        out_primal, out_tangent = jax.jvp(
            lambda p, tl, fl: p * tl + (1.0 - p) * fl,
            (p, tp, fp),
            (p_tan, tt, ft),
        )
        return Dual(out_primal, out_tangent)


@Pytree.dataclass
class FlipEnumParallel(ADEVPrimitive):
    """Enumeration with both branches evaluated under one ``vmap`` (a single
    batched XLA program). Parity: reference
    ``primitives.py:183-217``."""

    def sample(self, key, p):
        return jr.bernoulli(key, p)

    def enum_support(self, p):
        return jnp.array([True, False])

    def enum_probs(self, p):
        return jnp.stack([p, 1.0 - p])

    def jvp_estimate(self, key, dual_args, konts):
        _, kdual = konts
        (p_dual,) = dual_args
        p, p_tan = p_dual.primal, p_dual.tangent
        sub_keys = jr.split(key, 2)
        support = jnp.array([True, False])

        def run(k, v):
            out = kdual(k, Dual.tree_pure(v))
            (pr,), (tg,) = Dual.tree_unzip(out)
            return pr, tg

        ret_primals, ret_tangents = jax.vmap(run)(sub_keys, support)
        out_primal, out_tangent = jax.jvp(
            lambda p, r: jnp.sum(jnp.stack([p, 1.0 - p]) * r),
            (p, ret_primals),
            (p_tan, ret_tangents),
        )
        return Dual(out_primal, out_tangent)


@Pytree.dataclass
class FlipMVD(ADEVPrimitive):
    """Measure-valued derivative for Bernoulli: exact pairwise difference
    using the pure continuation on the flipped sample.

    Parity: reference ``primitives.py:156-180``."""

    def sample(self, key, p):
        return jr.bernoulli(key, p)

    def jvp_estimate(self, key, dual_args, konts):
        kpure, kdual = konts
        (p_dual,) = dual_args
        p, p_tan = p_dual.primal, p_dual.tangent
        key, sub_key = jax.random.split(key)
        b = jr.bernoulli(sub_key, p)
        out_dual = kdual(key, Dual.tree_pure(b))
        (bp,), (bt,) = Dual.tree_unzip(out_dual)
        other = kpure(key, jnp.logical_not(b))
        est = jnp.where(b, 1.0, -1.0) * (bp - other)
        return Dual(bp, bt + est * p_tan)


@Pytree.dataclass
class CategoricalEnumParallel(ADEVPrimitive):
    """Exact enumeration over categorical support (logits), batched.

    Parity: reference ``primitives.py:220-252``."""

    def sample(self, key, logits):
        return jr.categorical(key, logits)

    def enum_support(self, logits):
        return jnp.arange(logits.shape[-1])

    def enum_probs(self, logits):
        return jax.nn.softmax(logits)

    def jvp_estimate(self, key, dual_args, konts):
        _, kdual = konts
        (logits_dual,) = dual_args
        logits, logits_tan = logits_dual.primal, logits_dual.tangent
        n = logits.shape[-1]
        sub_keys = jr.split(key, n)
        idxs = jnp.arange(n)

        def run(k, i):
            out = kdual(k, Dual.tree_pure(i))
            (pr,), (tg,) = Dual.tree_unzip(out)
            return pr, tg

        ret_primals, ret_tangents = jax.vmap(run)(sub_keys, idxs)
        out_primal, out_tangent = jax.jvp(
            lambda lg, r: jnp.sum(jax.nn.softmax(lg) * r),
            (logits, ret_primals),
            (logits_tan, ret_tangents),
        )
        return Dual(out_primal, out_tangent)


@Pytree.dataclass
class NormalREPARAM(TailCallADEVPrimitive):
    """Pathwise/reparameterization for Normal(loc, scale) — tail-call
    strategy (batches under vmap). Parity: reference
    ``primitives.py:271-298``."""

    def sample(self, key, loc, scale):
        shape = jnp.broadcast_shapes(jnp.shape(loc), jnp.shape(scale))
        return loc + scale * jr.normal(key, shape)

    def before_tail_call(self, key, dual_args):
        loc_dual, scale_dual = dual_args
        key, sub_key = jax.random.split(key)
        eps = jr.normal(sub_key, jnp.broadcast_shapes(
            jnp.shape(loc_dual.primal), jnp.shape(scale_dual.primal)
        ))
        primal_out, tangent_out = jax.jvp(
            lambda loc, scale: loc + scale * eps,
            (loc_dual.primal, scale_dual.primal),
            (loc_dual.tangent, scale_dual.tangent),
        )
        return Dual(primal_out, tangent_out)


@Pytree.dataclass
class MvNormalDiagREPARAM(TailCallADEVPrimitive):
    """Parity: reference ``primitives.py:301-335``."""

    def sample(self, key, loc, scale_diag):
        return loc + scale_diag * jr.normal(key, jnp.shape(loc))

    def before_tail_call(self, key, dual_args):
        loc_dual, diag_dual = dual_args
        key, sub_key = jax.random.split(key)
        eps = jr.normal(sub_key, jnp.shape(loc_dual.primal))
        primal_out, tangent_out = jax.jvp(
            lambda loc, diag: loc + diag * eps,
            (loc_dual.primal, diag_dual.primal),
            (loc_dual.tangent, diag_dual.tangent),
        )
        return Dual(primal_out, tangent_out)


@Pytree.dataclass
class MvNormalREPARAM(TailCallADEVPrimitive):
    """Full-covariance reparameterization via Cholesky.

    Parity: reference ``primitives.py:338-370``."""

    def sample(self, key, loc, cov):
        return jr.multivariate_normal(key, loc, cov)

    def before_tail_call(self, key, dual_args):
        loc_dual, cov_dual = dual_args
        key, sub_key = jax.random.split(key)
        eps = jr.normal(sub_key, jnp.shape(loc_dual.primal))

        def transform(loc, cov):
            L = jnp.linalg.cholesky(cov)
            return loc + L @ eps

        primal_out, tangent_out = jax.jvp(
            transform,
            (loc_dual.primal, cov_dual.primal),
            (loc_dual.tangent, cov_dual.tangent),
        )
        return Dual(primal_out, tangent_out)


@Pytree.dataclass
class UniformREPARAM(TailCallADEVPrimitive):
    """Uniform(0,1) — parameterless, zero tangent.

    Parity: reference ``primitives.py:373-389``."""

    def sample(self, key):
        return jr.uniform(key, ())

    def before_tail_call(self, key, dual_args):
        key, sub_key = jax.random.split(key)
        u = jr.uniform(sub_key, ())
        return Dual(u, jnp.zeros_like(u))


import numpy as _np

#: 64-node Gauss–Legendre rule on (0, 1), precomputed once — leggauss
#: runs an eigen-decomposition; per-trace recomputation is waste.
_GL64_NODES, _GL64_WEIGHTS = _np.polynomial.legendre.leggauss(64)
_GL64_U = (_GL64_NODES + 1.0) / 2.0
_GL64_W = _GL64_WEIGHTS / 2.0


def _beta_cdf_param_partials(x, a, b):
    """(∂F/∂a, ∂F/∂b) of the Beta CDF at x, by Gauss–Legendre quadrature of
    ∂F/∂a = ∫₀ˣ f(t)[ln t − (ψ(a) − ψ(a+b))] dt (and symmetrically for b)
    — ``jax.scipy.special.betainc`` has no parameter gradients."""
    u = jnp.asarray(_GL64_U)                      # (n,) on (0, 1)
    w = jnp.asarray(_GL64_W)
    t = x * u
    log_f = (
        (a - 1.0) * jnp.log(t)
        + (b - 1.0) * jnp.log1p(-t)
        - (jsp.gammaln(a) + jsp.gammaln(b) - jsp.gammaln(a + b))
    )
    f = jnp.exp(log_f)
    psi_ab = jsp.digamma(a + b)
    dFda = x * jnp.sum(
        w * f * (jnp.log(t) - (jsp.digamma(a) - psi_ab))
    )
    dFdb = x * jnp.sum(
        w * f * (jnp.log1p(-t) - (jsp.digamma(b) - psi_ab))
    )
    return dFda, dFdb


@Pytree.dataclass
class BetaIMPLICIT(TailCallADEVPrimitive):
    """Beta(a, b) via implicit reparameterization (Figurnov et al. 2018):
    dx/dθ = −(∂F/∂θ)/p(x;θ), with the CDF's parameter partials computed by
    quadrature (JAX's ``betainc`` lacks parameter gradients). Parity:
    reference ``primitives.py:392-420`` (TFP's implicit-gradient
    sampler)."""

    def sample(self, key, a, b):
        return jr.beta(key, a, b)

    def before_tail_call(self, key, dual_args):
        a_dual, b_dual = dual_args
        key, sub_key = jax.random.split(key)
        a, b = a_dual.primal, b_dual.primal
        x = jr.beta(sub_key, a, b)
        dFda, dFdb = _beta_cdf_param_partials(x, a, b)
        pdf = jnp.exp(jss.beta.logpdf(x, a, b))
        denom = jnp.maximum(pdf, 1e-30)
        x_tan = -(dFda * a_dual.tangent + dFdb * b_dual.tangent) / denom
        return Dual(x, x_tan)


@Pytree.dataclass
class GammaIMPLICIT(TailCallADEVPrimitive):
    """Gamma(shape, rate) via implicit reparameterization.

    ``jax.random.gamma`` carries a built-in implicit derivative w.r.t. the
    shape parameter (XLA's ``RandomGammaGrad``, i.e. the Figurnov et al.
    2018 gradient −(∂F/∂α)/p(x;α)), so a plain ``jax.jvp`` through the
    fixed-key sampler is exact — no quadrature needed (contrast
    :class:`BetaIMPLICIT`, where ``jr.beta``'s two-gamma composition is
    bypassed for a direct CDF computation). Rate enters pathwise as
    ``x = z / rate``. New scope vs the reference (its ADEV layer stops at
    Beta; see ``/root/reference/src/genjax/_src/adev/primitives.py:392``).
    """

    def sample(self, key, shape, rate):
        return jr.gamma(key, shape) / rate

    def before_tail_call(self, key, dual_args):
        shape_dual, rate_dual = dual_args
        key, sub_key = jax.random.split(key)
        primal_out, tangent_out = jax.jvp(
            lambda s, r: jr.gamma(sub_key, s) / r,
            (shape_dual.primal, rate_dual.primal),
            (shape_dual.tangent, rate_dual.tangent),
        )
        return Dual(primal_out, tangent_out)


@Pytree.dataclass
class DirichletIMPLICIT(TailCallADEVPrimitive):
    """Dirichlet(alpha) via the normalized-gamma construction
    ``x_i = z_i / Σz_j``, ``z_i ~ Gamma(alpha_i, 1)``, with implicit
    shape gradients flowing through ``jr.gamma``'s built-in derivative.
    New scope vs the reference ADEV layer."""

    def sample(self, key, alpha):
        return jr.dirichlet(key, alpha)

    def before_tail_call(self, key, dual_args):
        (alpha_dual,) = dual_args
        key, sub_key = jax.random.split(key)

        def transform(alpha):
            z = jr.gamma(sub_key, alpha)
            return z / jnp.sum(z, axis=-1, keepdims=True)

        primal_out, tangent_out = jax.jvp(
            transform, (alpha_dual.primal,), (alpha_dual.tangent,)
        )
        return Dual(primal_out, tangent_out)


@Pytree.dataclass
class Baseline(ADEVPrimitive):
    """Variance-reduced REINFORCE: control variate ``b`` subtracted from
    the continuation value in the score-function term; takes ``(b, *args)``.

    Parity: reference ``primitives.py:423-471``."""

    prim: REINFORCE

    def sample(self, key, b, *args):
        return self.prim.sample(key, *args)

    def jvp_estimate(self, key, dual_args, konts):
        _, kdual = konts
        b_dual, *rest_duals = dual_args
        primals = Dual.tree_primal(tuple(rest_duals))
        tangents = Dual.tree_tangent(tuple(rest_duals))
        key, sub_key = jax.random.split(key)
        v = self.prim.sample(sub_key, *primals)
        out_dual = kdual(key, Dual.tree_pure(v))
        (out_primal,), (out_tangent,) = Dual.tree_unzip(out_dual)
        _, lp_tangent = jax.jvp(
            lambda *params: self.prim.differentiable_logpdf(v, *params),
            tuple(primals),
            tuple(tangents),
        )
        return Dual(
            out_primal,
            out_tangent + (out_primal - b_dual.primal) * lp_tangent,
        )


def baseline(prim: REINFORCE) -> Baseline:
    return Baseline(prim)


@Pytree.dataclass
class AddCost(ADEVPrimitive):
    """Imperatively add a (differentiable) cost term to the expected loss.

    Parity: reference ``primitives.py:479-500``."""

    #: Marks this site's argument as a LOSS contribution — the pure
    #: continuation (``core._eval_pure``) must add it to the returned
    #: loss, not just pass it through as a value.
    is_cost = True

    def sample(self, key, w):
        return w

    def jvp_estimate(self, key, dual_args, konts):
        _, kdual = konts
        (w_dual,) = dual_args
        l_dual = kdual(key, w_dual)
        return Dual(
            w_dual.primal + l_dual.primal, w_dual.tangent + l_dual.tangent
        )


def add_cost(w):
    """Usage inside an ``@expectation`` program: ``add_cost(w)`` adds ``w``
    to the expected loss (via the gradient-estimation path, like reference
    ``primitives.py:498-500``)."""
    AddCost()(w)


# -- instances (parity: reference primitives.py:255-268 + exports) ---------

flip_enum = FlipEnum()
flip_enum_parallel = FlipEnumParallel()
flip_mvd = FlipMVD()
categorical_enum_parallel = CategoricalEnumParallel()
normal_reparam = NormalREPARAM()
mv_normal_diag_reparam = MvNormalDiagREPARAM()
mv_normal_reparam = MvNormalREPARAM()
uniform = UniformREPARAM()
beta_implicit = BetaIMPLICIT()
gamma_implicit = GammaIMPLICIT()
dirichlet_implicit = DirichletIMPLICIT()

flip_reinforce = reinforce(
    lambda key, p: jr.bernoulli(key, p),
    lambda v, p: jss.bernoulli.logpmf(v, p),
)

geometric_reinforce = reinforce(
    lambda key, p: jnp.floor(
        jnp.log1p(-jr.uniform(key, jnp.shape(p))) / jnp.log1p(-p)
    ).astype(jnp.int32),
    lambda v, p: jax.scipy.special.xlog1py(
        jnp.asarray(v, jnp.result_type(float)), -p
    ) + jnp.log(p),
)

# Sampler broadcasts eps over the parameter shape (a scalar eps would
# perfectly CORRELATE the components while the summed logpdf scores
# them as independent — sample/density mismatch); logpdf sums so the
# score-function term is the joint density's.
normal_reinforce = reinforce(
    lambda key, loc, scale: loc + scale * jr.normal(
        key, jnp.broadcast_shapes(jnp.shape(loc), jnp.shape(scale))
    ),
    lambda v, loc, scale: jnp.sum(jss.norm.logpdf(v, loc, scale)),
)
