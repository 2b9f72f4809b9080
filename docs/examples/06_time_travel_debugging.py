"""The time-travel debugger: record frames, navigate, run
counterfactuals."""

import jax
import jax.numpy as jnp

import genjax_xla as g
from genjax_xla.core.compiler.interpreters.time_travel import (
    rec,
    time_machine,
)


@g.gen
def model(mu):
    x = g.normal(mu, 1.0) @ "x"
    doubled = rec(x * 2.0, name="doubled")
    y = g.normal(doubled, 0.1) @ "y"
    return rec(y + 1.0, name="shifted")


if __name__ == "__main__":
    key = jax.random.key(0)
    dbg = time_machine(
        lambda mu: model.simulate(key, (mu,)).get_retval()
    )(0.5)
    print(dbg)
    print("frame 'doubled':", dbg.jump("doubled").frame.value)
    print("final:", dbg.final)
    # Counterfactual: what if the doubled value had been 10?
    print("counterfactual:", dbg.resume(value=jnp.asarray(10.0)))
    # Re-execute with different arguments:
    print("remix(5.0) final:", dbg.remix(5.0).final)
