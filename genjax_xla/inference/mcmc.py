"""MCMC drivers: Metropolis–Hastings accept/reject over edit requests, and
jit-friendly chain runners — including vectorized multi-chain execution
whose chain axis shards over a device mesh.

New scope relative to the reference (which leaves accept/reject to user
code in its tests, ``tests/inference/test_requests.py:120-193``): here the
accept step, chain loop, and cross-chain summaries are library primitives,
because accelerator-scale MCMC wants the whole chain inside one ``lax.scan`` and
many chains inside one ``vmap``/``shard_map``.
"""

from __future__ import annotations

from typing import Any, Callable

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
from jax import lax

from genjax_xla.core.pytree import Pytree
from genjax_xla.gfi.concepts import EditRequest
from genjax_xla.gfi.gfn import Trace

__all__ = ["mh", "chain", "multi_chain"]


def mh(key: jax.Array, trace: Trace[Any],
       request: EditRequest) -> tuple[Trace[Any], jax.Array]:
    """One Metropolis–Hastings step: apply ``request`` as the proposal, and
    accept with probability ``min(1, exp(weight))`` (the edit weight IS the
    log acceptance ratio for weight-antisymmetric requests like
    ``Regenerate``/``Rejuvenate``/``HMC``). Returns ``(trace, accepted)``.
    """
    key, accept_key = jax.random.split(key)
    new_trace, w, _rd, _bwd = trace.edit(key, request)
    log_u = jnp.log(jax.random.uniform(accept_key, ()))
    accept = log_u < w
    try:
        out = jtu.tree_map(
            lambda new, old: jnp.where(accept, new, old), new_trace,
            trace,
        )
    except ValueError:
        # Structural static metadata can differ by OBJECT IDENTITY
        # between the two traces even when the model is the same —
        # combinator sugar built inline in a @gen body (e.g.
        # ``c0.mix(c1)(...) @ "m"``) creates fresh function closures
        # per trace of the body, and functions compare by identity.
        # The LEAVES still align one-to-one, so select leafwise and
        # keep the accepted side's static structure (round 5).
        new_leaves, new_def = jtu.tree_flatten(new_trace)
        old_leaves, old_def = jtu.tree_flatten(trace)
        if len(new_leaves) != len(old_leaves):
            raise
        out = jtu.tree_unflatten(
            new_def,
            [jnp.where(accept, n, o)
             for n, o in zip(new_leaves, old_leaves)],
        )
    return out, accept


def chain(kernel: Callable[[jax.Array, Trace[Any]],
                           tuple[Trace[Any], Any]]):
    """Lift a trace kernel ``(key, trace) -> (trace, aux)`` into a chain
    runner ``(key, trace, n_steps) -> (final_trace, stacked_aux)`` running
    entirely inside one ``lax.scan``."""

    def run(key: jax.Array, trace: Trace[Any], *, n_steps: int,
            burn_in: int = 0, collect: Callable[[Trace[Any]], Any]
            | None = None):
        """``n_steps`` is the TOTAL number of kernel applications;
        ``burn_in`` only trims the returned collection (``n_steps −
        burn_in`` samples come back)."""
        def step(tr, i):
            step_key = jax.random.fold_in(key, i)
            new_tr, aux = kernel(step_key, tr)
            out = collect(new_tr) if collect is not None else aux
            return new_tr, out

        def burn_step(tr, i):
            step_key = jax.random.fold_in(key, i)
            new_tr, _aux = kernel(step_key, tr)
            return new_tr, None

        # Two scans: the burn-in scan materializes NO outputs, so peak
        # memory is proportional to the RETURNED samples (a single scan
        # stacking all n_steps then slicing would hold n_steps/(n_steps
        # − burn_in)× the needed memory). Keys stay fold_in(key, i) over
        # the global step index — bitwise identical to the single-scan
        # collection.
        trace, _ = lax.scan(burn_step, trace, jnp.arange(burn_in))
        final, outs = lax.scan(
            step, trace, jnp.arange(burn_in, n_steps)
        )
        return final, outs

    return run


def multi_chain(kernel, n_chains: int):
    """Vectorize a chain runner over ``n_chains`` independent chains (the
    chain axis is a plain vmap axis — shardable over a mesh)."""
    runner = chain(kernel)

    def run(key: jax.Array, trace_init_fn, *, n_steps: int,
            burn_in: int = 0, collect=None):
        keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(
            jnp.arange(n_chains)
        )
        init_traces = jax.vmap(trace_init_fn)(keys)

        def one(key, tr):
            run_key = jax.random.fold_in(key, 0x5EED)
            return runner(run_key, tr, n_steps=n_steps,
                          burn_in=burn_in, collect=collect)

        return jax.vmap(one)(keys, init_traces)

    return run
