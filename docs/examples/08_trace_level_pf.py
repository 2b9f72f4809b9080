"""Trace-level particle filtering: condition a scan model on observations
one step at a time through the GFI (O(1) per step via IndexRequest)."""

import jax
import jax.numpy as jnp

from genjax_xla.inference import trace_particle_filter
from genjax_xla.models import kalman_filter, lgssm_model

if __name__ == "__main__":
    a, q, r, T = 0.9, 0.5, 0.3, 10
    model = lgssm_model(a, q, r, T)
    data = model.simulate(jax.random.key(7), (0.0, None))
    ys = jnp.stack([data.get_choices()[t, "y"] for t in range(T)])

    pf = trace_particle_filter(model, (0.0, None), "y", ys, 4096)
    result = jax.jit(pf)(jax.random.key(0))
    exact, _ = kalman_filter(ys, a, q, r, 0.0, 0.0)
    print("logZ:", float(result.log_z), " exact:", float(exact))
    print("ESS history:", [f"{e:.0f}" for e in result.ess_history])
