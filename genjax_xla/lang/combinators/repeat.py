"""``repeat``: n independent draws of a gen fn on the same arguments.

Parity target: ``/root/reference/src/genjax/_src/generative_functions/
combinators/repeat.py:28-77`` (vmap ∘ contramap over a dummy index there;
here simply ``Vmap`` with ``in_axes=None`` + ``axis_size`` — the per-lane
keys are the only mapped input).
"""

from __future__ import annotations

from typing import Callable

from genjax_xla.gfi.gfn import GenerativeFunction
from genjax_xla.lang.combinators.vmap import Vmap

__all__ = ["repeat"]


def repeat(*, n: int) -> Callable:
    from genjax_xla.core.argcheck import check_static_int

    check_static_int(n, "repeat(n=...)")
    """``gf.repeat(n=k)``: choices live under lane addresses ``0..n-1``."""

    def decorator(gen_fn: GenerativeFunction):
        return Vmap(gen_fn, in_axes=None, axis_size=n)

    return decorator
