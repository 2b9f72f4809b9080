"""Public-API argument validation (core/validate.py): helpful
TypeErrors on the classic misuse patterns, zero effect on valid calls,
and an escape hatch. Parity intent: the reference's package-wide
beartype install (`/root/reference/src/genjax/__init__.py:23-33`)."""

import jax
import jax.numpy as jnp
import pytest

import genjax_xla as g
from genjax_xla.core.validate import no_validation

KEY = jax.random.key(0)


@g.gen
def model(mu):
    x = g.normal(mu, 1.0) @ "x"
    return x


class TestMisuseErrors:
    def test_args_not_tuple(self):
        with pytest.raises(TypeError, match=r"args must be a tuple"):
            model.simulate(KEY, 0.5)

    def test_single_arg_hint(self):
        with pytest.raises(TypeError, match=r"\(x,\)"):
            model.simulate(KEY, 0.5)

    def test_key_not_key(self):
        with pytest.raises(TypeError, match="PRNG key"):
            model.simulate(42, (0.5,))

    def test_swapped_key_and_args(self):
        with pytest.raises(TypeError, match="key position"):
            model.simulate((0.5,), KEY)

    def test_assess_wants_choice_map(self):
        with pytest.raises(TypeError, match="ChoiceMap"):
            model.assess({"x": 1.0}, (0.5,))

    def test_generate_wants_choice_map(self):
        with pytest.raises(TypeError, match="ChoiceMap"):
            model.generate(KEY, {"x": 1.0}, (0.5,))

    def test_distribution_direct(self):
        with pytest.raises(TypeError, match="args must be a tuple"):
            g.normal.simulate(KEY, 0.0)


class TestValidCallsUnchanged:
    def test_typed_and_legacy_keys_accepted(self):
        tr = model.simulate(KEY, (0.5,))
        legacy = jax.random.PRNGKey(0)
        tr2 = model.simulate(legacy, (0.5,))
        assert jnp.isfinite(tr.get_score())
        assert jnp.isfinite(tr2.get_score())

    def test_under_jit_and_vmap(self):
        f = jax.jit(lambda k: model.simulate(k, (0.5,)).get_score())
        assert jnp.isfinite(f(KEY))
        keys = jax.random.split(KEY, 4)
        scores = jax.vmap(
            lambda k: model.simulate(k, (0.5,)).get_score()
        )(keys)
        assert scores.shape == (4,)

    def test_assess_valid(self):
        score, _ = model.assess(g.C["x"].set(1.0), (0.5,))
        assert jnp.isfinite(score)


class TestEscapeHatch:
    def test_no_validation_context(self):
        # Inside the context the type gate is off; the failure (if any)
        # comes from the implementation, not the validator.
        with no_validation():
            with pytest.raises(Exception) as ei:
                model.simulate(KEY, 0.5)
            assert "args must be a tuple" not in str(ei.value)
