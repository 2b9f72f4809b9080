"""``mix``: mixture-of-generative-functions — a categorical over branch
logits composed with ``Switch`` inside a ``@gen`` body.

Parity target: ``/root/reference/src/genjax/_src/generative_functions/
combinators/mixture.py:27-81`` (addresses: "mixture_component" for the
categorical draw, "mixture_branch" for the branch choices).
"""

from __future__ import annotations

from genjax_xla.gfi.gfn import GenerativeFunction
from genjax_xla.lang.combinators.switch import Switch
from genjax_xla.lang.static import gen

__all__ = ["mix"]


#: mix(...) built per call would mint a fresh ``mixture`` closure each
#: time; since function-valued static fields compare by IDENTITY, the
#: common inline pattern ``c0.mix(c1)(...) @ "m"`` inside a @gen body
#: would then produce traces whose static structure differs on every
#: execution — breaking lax.scan carries and accept/reject tree_maps in
#: MCMC drivers (round-5 fuzz find). Cache by the component tuple so
#: repeated construction returns the identical object.
_MIX_CACHE: dict = {}


def mix(*fns: GenerativeFunction) -> GenerativeFunction:
    """Args: ``(logits, branch0_args, branch1_args, ...)``; samples a
    component ~ categorical(logits), then that branch."""
    from genjax_xla.core.argcheck import check_gen_fns

    check_gen_fns(fns, "mix")
    try:
        cached = _MIX_CACHE.get(fns)
    except TypeError:                    # unhashable component
        cached = None
    if cached is not None:
        return cached
    from genjax_xla.lang.distributions import categorical

    sw = Switch(tuple(fns))

    @gen
    def mixture(logits, *branch_args):
        idx = categorical(logits) @ "mixture_component"
        return sw(idx, *branch_args) @ "mixture_branch"

    try:
        if len(_MIX_CACHE) > 256:
            _MIX_CACHE.clear()
        _MIX_CACHE[fns] = mixture
    except TypeError:
        pass
    return mixture
