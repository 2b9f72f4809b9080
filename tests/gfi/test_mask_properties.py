"""Property-based Mask algebra laws (hypothesis), mirroring the
reference's one hypothesis-using suite (``tests/core/test_choice_maps.py``
— SURVEY §4.1), plus checkify failure of invalid ``unmask`` under
``do_checkify`` (reference ``tests/core/generative/test_functional_types
.py:44``)."""

import jax
import jax.numpy as jnp
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import genjax_xla as g
from genjax_xla.gfi.mask import Mask

flags = st.booleans()
values = st.floats(
    min_value=-1e6, max_value=1e6, allow_nan=False, allow_infinity=False
)


@settings(max_examples=50, deadline=None)
@given(values, flags, values, flags)
def test_or_flag_law(v1, f1, v2, f2):
    m = Mask(jnp.asarray(v1), f1) | Mask(jnp.asarray(v2), f2)
    assert bool(jnp.asarray(m.flag)) == (f1 or f2)


@settings(max_examples=50, deadline=None)
@given(values, flags, values, flags)
def test_xor_flag_law(v1, f1, v2, f2):
    m = Mask(jnp.asarray(v1), f1) ^ Mask(jnp.asarray(v2), f2)
    assert bool(jnp.asarray(m.flag)) == (f1 != f2)


@settings(max_examples=50, deadline=None)
@given(values, flags, values, flags)
def test_or_prefers_left_when_valid(v1, f1, v2, f2):
    m = Mask(jnp.asarray(v1), f1) | Mask(jnp.asarray(v2), f2)
    if f1:
        assert float(m.value) == pytest.approx(v1)
    elif f2:
        assert float(m.value) == pytest.approx(v2)


@settings(max_examples=30, deadline=None)
@given(values, flags)
def test_build_and_composition(v, f):
    m = Mask.build(Mask.build(jnp.asarray(v), f), True)
    assert bool(jnp.asarray(m.flag)) == f
    m2 = Mask.build(Mask.build(jnp.asarray(v), True), f)
    assert bool(jnp.asarray(m2.flag)) == f


@settings(max_examples=30, deadline=None)
@given(st.lists(st.tuples(values, flags), min_size=1, max_size=5))
def test_or_n_associativity(pairs):
    masks = [Mask(jnp.asarray(v), f) for v, f in pairs]
    left = Mask.or_n(*masks)
    expected_flag = any(f for _, f in pairs)
    assert bool(jnp.asarray(left.flag)) == expected_flag
    if expected_flag:
        first_valid = next(v for v, f in pairs if f)
        assert float(left.value) == pytest.approx(first_valid)


def test_unmask_checkify_failure():
    """Invalid unmask raises under do_checkify, passes silently outside."""
    m = Mask(jnp.asarray(1.0), jnp.asarray(False))
    # Outside do_checkify: no error.
    assert float(m.unmask()) == 1.0

    from jax.experimental import checkify

    with g.do_checkify():
        def f():
            return m.unmask()

        err, _ = checkify.checkify(f)()
        with pytest.raises(Exception):
            err.throw()


def test_unmask_default_lanes():
    m = Mask(jnp.asarray([1.0, 2.0, 3.0]),
             jnp.asarray([True, False, True]))
    out = m.unmask(default=jnp.zeros(3))
    assert jnp.allclose(out, jnp.asarray([1.0, 0.0, 3.0]))
