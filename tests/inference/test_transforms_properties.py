"""Property-based bijector laws: roundtrip identity and fldj-vs-autodiff
agreement for every support transform (hypothesis)."""

import jax
import jax.numpy as jnp
import numpy as np
from hypothesis import given, settings
from hypothesis import strategies as st

from genjax_xla.inference.transforms import (
    get_bijector,
    interval,
    positive,
    simplex,
)

finite = st.floats(-4.0, 4.0, allow_nan=False)


@settings(max_examples=40, deadline=None)
@given(finite)
def test_positive_roundtrip_and_fldj(u):
    u = jnp.asarray(u)
    x = positive.forward(u)
    assert float(x) > 0.0
    assert abs(float(positive.inverse(x)) - float(u)) < 1e-4
    want = float(jnp.log(jnp.abs(jax.grad(positive.forward)(u))))
    assert abs(float(positive.fldj(u)) - want) < 1e-5


@settings(max_examples=40, deadline=None)
@given(finite, st.floats(-3.0, 0.0), st.floats(0.5, 3.0))
def test_interval_roundtrip_and_fldj(u, low, high):
    bij = interval(low, high)
    u = jnp.asarray(u)
    x = bij.forward(u)
    assert low < float(x) < high
    assert abs(float(bij.inverse(x)) - float(u)) < 1e-3
    want = float(jnp.log(jnp.abs(jax.grad(bij.forward)(u))))
    assert abs(float(bij.fldj(u)) - want) < 1e-4


@settings(max_examples=25, deadline=None)
@given(st.lists(finite, min_size=1, max_size=6))
def test_simplex_roundtrip_sum_and_fldj(us):
    u = jnp.asarray(us)
    x = simplex.forward(u)
    assert x.shape == (u.shape[0] + 1,)
    assert abs(float(x.sum()) - 1.0) < 1e-5
    assert np.all(np.asarray(x) > 0.0)
    assert np.allclose(np.asarray(simplex.inverse(x)), np.asarray(u),
                       atol=1e-3)
    J = jax.jacfwd(lambda u: simplex.forward(u)[:-1])(u)
    want = float(jnp.linalg.slogdet(J)[1])
    assert abs(float(simplex.fldj(u)) - want) < 1e-4


def test_get_bijector_specs():
    assert get_bijector("positive") is positive
    assert get_bijector(positive) is positive
    b = get_bijector((0.0, 1.0))
    assert abs(float(b.forward(jnp.asarray(0.0))) - 0.5) < 1e-6
