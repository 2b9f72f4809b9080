"""``or_else``: two-branch switch on a boolean — derived from ``Switch`` +
``contramap``.

Parity target: ``/root/reference/src/genjax/_src/generative_functions/
combinators/or_else.py:23-84``.
"""

from __future__ import annotations

import jax.numpy as jnp

from genjax_xla.gfi.gfn import GenerativeFunction
from genjax_xla.lang.combinators.dimap import Dimap
from genjax_xla.lang.combinators.switch import Switch

__all__ = ["OrElse", "or_else"]


#: Same identity-caching rationale as ``mixture._MIX_CACHE``: a fresh
#: ``pre`` closure per call would make inline ``a.or_else(b)(...)``
#: traces structurally unequal across executions (round-5 fuzz find).
_OR_ELSE_CACHE: dict = {}


def OrElse(if_fn: GenerativeFunction,
           else_fn: GenerativeFunction) -> GenerativeFunction:
    """Args: ``(bool_flag, if_args, else_args)``; runs ``if_fn`` when the
    flag is true, ``else_fn`` otherwise."""
    key = (if_fn, else_fn)
    try:
        cached = _OR_ELSE_CACHE.get(key)
    except TypeError:
        cached = None
    if cached is not None:
        return cached
    sw = Switch((if_fn, else_fn))

    def pre(flag, if_args, else_args):
        idx = jnp.asarray(jnp.logical_not(flag), jnp.int32)
        return (idx, if_args, else_args)

    out = Dimap(sw, pre=pre)
    try:
        if len(_OR_ELSE_CACHE) > 256:
            _OR_ELSE_CACHE.clear()
        _OR_ELSE_CACHE[key] = out
    except TypeError:
        pass
    return out


def or_else(else_fn: GenerativeFunction):
    from genjax_xla.core.argcheck import check_gen_fn

    check_gen_fn(else_fn, "or_else")
    def decorator(if_fn: GenerativeFunction):
        return OrElse(if_fn, else_fn)

    return decorator
