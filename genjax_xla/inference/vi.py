"""Variational inference via ADEV: differentiable distribution wrappers for
guide programs, and loss-gradient estimators (ELBO / IWELBO / PWake /
QWake), each an ``@expectation`` program differentiated by the ADEV
interpreter.

Parity target: ``/root/reference/src/genjax/_src/inference/vi.py``
(``adev_distribution`` :61-81, guide-side primitives :90-116, ``ELBO`` :129,
``IWELBO`` :154, ``PWake`` :180, ``QWake`` :207).
"""

from __future__ import annotations

from typing import Any, Callable

import jax
import jax.numpy as jnp

from genjax_xla.adev.core import ADEVPrimitive, expectation, sample_primitive
from genjax_xla.adev import primitives as adev_prims
from genjax_xla.gfi.choice_map import ChoiceMap
from genjax_xla.lang.distributions import stdlib
from genjax_xla.lang.distributions.distribution import (
    ExactDensity,
    exact_density,
)
from genjax_xla.inference.sp import SampleDistribution, Target
from genjax_xla.inference.smc import Importance, ImportanceK

__all__ = [
    "adev_distribution",
    "ELBO",
    "IWELBO",
    "PWake",
    "QWake",
    "flip_enum",
    "flip_mvd",
    "flip_reinforce",
    "categorical_enum",
    "normal_reinforce",
    "normal_reparam",
    "mv_normal_diag_reparam",
    "mv_normal_reparam",
    "geometric_reinforce",
    "beta_implicit",
    "gamma_implicit",
    "dirichlet_implicit",
]


def adev_distribution(adev_primitive: ADEVPrimitive,
                      differentiable_logpdf: Callable,
                      name: str) -> ExactDensity:
    """An ``ExactDensity`` whose sampler binds an ADEV primitive — usable
    inside ``@gen`` guide programs so that guide randomness carries a
    gradient strategy. Parity: reference ``vi.py:61-81``."""

    def sampler(key, *args):
        return sample_primitive(adev_primitive, *args, key=key)

    def logpdf(v, *args):
        lp = differentiable_logpdf(v, *args)
        if jnp.shape(lp):
            return jnp.sum(lp)
        return lp

    return exact_density(sampler, logpdf, name)


def _logpdf_of(dist) -> Callable:
    return lambda v, *args: dist.logpdf(v, *args)


#: Guide-side differentiable distributions (parity: reference vi.py:90-116).
flip_enum = adev_distribution(
    adev_prims.flip_enum, _logpdf_of(stdlib.flip), "flip_enum"
)
flip_mvd = adev_distribution(
    adev_prims.flip_mvd, _logpdf_of(stdlib.flip), "flip_mvd"
)
#: Score-function flip. Both this and the enumeration variants batch
#: under ``.vmap()`` guides (``_lift_reinforce`` / BatchedEnumPrimitive
#: in adev/core.py); only REINFORCE additionally composes under NESTED
#: vmaps (it re-lifts).
flip_reinforce = adev_distribution(
    adev_prims.flip_reinforce, _logpdf_of(stdlib.flip), "flip_reinforce"
)
categorical_enum = adev_distribution(
    adev_prims.categorical_enum_parallel,
    _logpdf_of(stdlib.categorical),
    "categorical_enum",
)
normal_reinforce = adev_distribution(
    adev_prims.normal_reinforce, _logpdf_of(stdlib.normal),
    "normal_reinforce",
)
normal_reparam = adev_distribution(
    adev_prims.normal_reparam, _logpdf_of(stdlib.normal), "normal_reparam"
)
mv_normal_diag_reparam = adev_distribution(
    adev_prims.mv_normal_diag_reparam,
    lambda v, loc, diag: jnp.sum(
        jax.scipy.stats.norm.logpdf(v, loc, diag)
    ),
    "mv_normal_diag_reparam",
)
mv_normal_reparam = adev_distribution(
    adev_prims.mv_normal_reparam,
    lambda v, loc, cov: jax.scipy.stats.multivariate_normal.logpdf(
        v, loc, cov
    ),
    "mv_normal_reparam",
)
geometric_reinforce = adev_distribution(
    adev_prims.geometric_reinforce, _logpdf_of(stdlib.geometric),
    "geometric_reinforce",
)
beta_implicit = adev_distribution(
    adev_prims.beta_implicit, _logpdf_of(stdlib.beta), "beta_implicit"
)
gamma_implicit = adev_distribution(
    adev_prims.gamma_implicit, _logpdf_of(stdlib.gamma), "gamma_implicit"
)
dirichlet_implicit = adev_distribution(
    adev_prims.dirichlet_implicit,
    _logpdf_of(stdlib.dirichlet),
    "dirichlet_implicit",
)


# ---------------------------------------------------------------------------
# Loss-gradient estimators
# ---------------------------------------------------------------------------
#
# All four estimators share two shells. Every loss here is the negative
# expectation of some log-quantity of the target built from the call's
# args; the shells own the @expectation plumbing and key discipline, the
# individual estimators supply only the quantity:
#
# - _neg_logz_loss: the quantity is the log normalizing-constant
#   estimate of an SMC algorithm over the target (ELBO = 1-particle
#   Importance, IWELBO = K-particle). Differentiating −logẐ through
#   ADEV gives the (IW)ELBO gradient with the guide's strategies.
# - _wake_loss: the quantity is a score of a sample proposed from a
#   posterior approximation (wake-sleep): PWake scores it under the
#   model (θ update), QWake under the guide (φ update).


def _neg_logz_loss(make_target: Callable[..., Target],
                   make_alg: Callable[[Target], Any]) -> Callable:
    def grad_estimate(key: jax.Array, args: tuple):
        @expectation
        def _loss(*target_args):
            target = make_target(*target_args)
            return -make_alg(target).estimate_normalizing_constant(
                key, target
            )

        return _loss.grad_estimate(key, args)

    return grad_estimate


def _wake_loss(posterior_approx: SampleDistribution,
               make_target: Callable[..., Target],
               score: Callable) -> Callable:
    """``score(key, target, sample) -> log-quantity``; the loss is its
    negative expectation over samples from ``posterior_approx``."""

    def grad_estimate(key: jax.Array, args: tuple):
        key, k_prop, k_score = jax.random.split(key, 3)

        @expectation
        def _loss(*target_args):
            target = make_target(*target_args)
            _, sample = posterior_approx.random_weighted(k_prop, target)
            return -score(k_score, target, sample)

        return _loss.grad_estimate(key, args)

    return grad_estimate


def ELBO(guide: SampleDistribution,
         make_target: Callable[..., Target]) -> Callable:
    """∇ of −E_q[log p̃/q] (the negative evidence lower bound).

    Parity: reference ``vi.py:129-151``."""
    return _neg_logz_loss(
        make_target, lambda target: Importance(target, guide)
    )


def IWELBO(proposal: SampleDistribution,
           make_target: Callable[..., Target], N: int) -> Callable:
    """K-particle importance-weighted ELBO gradient.

    Parity: reference ``vi.py:154-177``."""
    return _neg_logz_loss(
        make_target, lambda target: ImportanceK(target, proposal, N)
    )


def PWake(posterior_approx: SampleDistribution,
          make_target: Callable[..., Target]) -> Callable:
    """Wake-phase model update: ∇_θ −E_{z~q*}[log p_θ(z, x)].

    Parity: reference ``vi.py:180-204``."""

    def model_score(key, target, sample):
        tr, _ = target.importance(key, sample)
        return tr.get_score()

    return _wake_loss(posterior_approx, make_target, model_score)


def QWake(proposal: SampleDistribution,
          posterior_approx: SampleDistribution,
          make_target: Callable[..., Target]) -> Callable:
    """Sleep-phase guide update: ∇_φ −E_{z~q*}[log q_φ(z | x)].

    Parity: reference ``vi.py:207-232``."""

    def guide_score(key, target, sample):
        return proposal.estimate_logpdf(key, sample, target)

    return _wake_loss(posterior_approx, make_target, guide_score)
