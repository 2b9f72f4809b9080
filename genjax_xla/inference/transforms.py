"""Support transforms (bijectors): run gradient-based samplers in
unconstrained space for positive / interval-constrained latents, with the
change-of-variables correction applied to the target log-density.

New scope (ROADMAP item): neither the reference nor round-1 NUTS handled
constrained supports — users had to reparameterize by hand.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from genjax_xla.gfi.choice_map import (
    Choice,
    ChoiceMap,
    Empty,
    Filtered,
    Indexed,
    Or,
    Static,
    Switch,
)
from genjax_xla.gfi.mask import Mask

__all__ = ["Bijector", "identity", "positive", "interval", "simplex",
           "PerBranch", "get_bijector", "constrain_choices",
           "unconstrain_choices", "infer_transforms",
           "path_present", "resolve_transforms"]


class Bijector(NamedTuple):
    """u (unconstrained) <-> x (constrained)."""

    forward: Callable   # u -> x
    inverse: Callable   # x -> u
    fldj: Callable      # u -> log |det d forward / du|  (summed)


identity = Bijector(
    forward=lambda u: u,
    inverse=lambda x: x,
    fldj=lambda u: jnp.zeros(()),
)

#: (0, ∞) via softplus (numerically tame both directions).
positive = Bijector(
    forward=lambda u: jax.nn.softplus(u),
    inverse=lambda x: x + jnp.log(-jnp.expm1(-x)),
    fldj=lambda u: jnp.sum(jax.nn.log_sigmoid(u)),
)


def interval(low: float, high: float) -> Bijector:
    """(low, high) via scaled sigmoid."""
    width = high - low

    return Bijector(
        forward=lambda u: low + width * jax.nn.sigmoid(u),
        inverse=lambda x: jax.scipy.special.logit((x - low) / width),
        fldj=lambda u: jnp.sum(
            jnp.log(width) + jax.nn.log_sigmoid(u)
            + jax.nn.log_sigmoid(-u)
        ),
    )


def _stick_breaking_offsets(km1):
    # Stan's offset: u = 0 maps to the uniform simplex.
    return -jnp.log(jnp.arange(km1, 0, -1, dtype=jnp.float32))


def _simplex_forward(u):
    """u ∈ R^{K-1} → x ∈ Δ^{K-1} (K components) via stick-breaking."""
    t = u + _stick_breaking_offsets(u.shape[-1])
    z = jax.nn.sigmoid(t)
    om = 1.0 - z
    cp = jnp.concatenate([jnp.ones(u.shape[:-1] + (1,)),
                          jnp.cumprod(om, axis=-1)], axis=-1)
    head = z * cp[..., :-1]
    return jnp.concatenate([head, cp[..., -1:]], axis=-1)


def _simplex_inverse(x):
    # Stable stick-breaking inverse: the remaining mass rem_k =
    # Σ_{j≥k} x_j is a SUFFIX sum (all positive adds — computing it as
    # 1 − cumsum cancels catastrophically once the tail sticks shrink
    # below f32 epsilon, hypothesis-found), and
    #   logit(z_k) = log(x_k) − log(rem_k − x_k) = log(x_k) − log(rem_{k+1}).
    head = x[..., :-1]
    suffix = jnp.cumsum(x[..., ::-1], axis=-1)[..., ::-1]
    tail = suffix[..., 1:]                       # rem_{k+1}
    tiny = jnp.finfo(x.dtype).tiny
    return (
        jnp.log(jnp.maximum(head, tiny))
        - jnp.log(jnp.maximum(tail, tiny))
        - _stick_breaking_offsets(head.shape[-1])
    )


def _simplex_fldj(u):
    # Triangular Jacobian: |J| = Π_k σ'(t_k) · (remaining stick)_k.
    t = u + _stick_breaking_offsets(u.shape[-1])
    z = jax.nn.sigmoid(t)
    cp = jnp.concatenate([jnp.ones(u.shape[:-1] + (1,)),
                          jnp.cumprod(1.0 - z, axis=-1)[..., :-1]], axis=-1)
    return jnp.sum(
        jax.nn.log_sigmoid(t) + jax.nn.log_sigmoid(-t) + jnp.log(cp)
    )


#: Δ^{K-1} via stick-breaking (Stan-style offsets); note the unconstrained
#: side has K-1 dims for a K-component simplex — ``constrain_choices``
#: handles the shape change because raveling happens on the
#: unconstrained choice map.
simplex = Bijector(
    forward=_simplex_forward,
    inverse=_simplex_inverse,
    fldj=_simplex_fldj,
)


_NAMED = {"identity": identity, "positive": positive, "simplex": simplex}


#: Sentinel distinguishing "address absent in this Switch branch" from
#: "present but unconstrained" (= None) during support inference.
_ABSENT = object()


class PerBranch(NamedTuple):
    """Branch-dependent bijector specs for an address that lives under a
    :class:`Switch` node with different supports per branch (e.g. ``"x"``
    is normal in branch 0 but gamma in branch 1). ``specs[b]`` applies to
    branch ``b``'s leaf; ``None`` means identity. Built automatically by
    :func:`infer_transforms` when branch supports disagree."""

    specs: tuple


def get_bijector(spec) -> Bijector:
    if isinstance(spec, Bijector):
        return spec
    if spec is None:
        return identity
    if isinstance(spec, str):
        if spec == "unit_interval":
            # The support-metadata string for (0, 1) supports
            # (distribution.get_support docstring).
            return interval(0.0, 1.0)
        try:
            return _NAMED[spec]
        except KeyError:
            raise ValueError(f"Unknown bijector spec: {spec!r}") from None
    if isinstance(spec, tuple) and len(spec) == 2:
        return interval(*spec)
    raise ValueError(f"Unknown bijector spec: {spec!r}")


def _spec_equal(a, b) -> bool:
    """Support-spec equality that tolerates array-valued interval
    bounds (vector-arg uniform/truncated sites): tuple-wise recursive,
    array leaves compared with np.array_equal (a bare ``==`` raises
    'truth value of an array is ambiguous')."""
    import numpy as _np

    if isinstance(a, tuple) and isinstance(b, tuple):
        return len(a) == len(b) and all(
            _spec_equal(x, y) for x, y in zip(a, b)
        )
    if isinstance(a, str) or isinstance(b, str):
        return a == b
    if a is None or b is None:
        return a is b
    try:
        return bool(_np.array_equal(_np.asarray(a), _np.asarray(b)))
    except Exception:
        return a is b


def _addr_path(addr) -> tuple:
    return addr if isinstance(addr, tuple) else (addr,)


def _and_gate(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return jnp.logical_and(a, b)


def _map_at(chm: ChoiceMap, path: tuple, fn: Callable, gate=None,
            branch=()):
    """Structurally replace the leaf at ``path`` with
    ``fn(value, gate, branch)``, returning ``(new_chm, found)``.
    :class:`Indexed` nodes (Scan/Vmap choices) are transparent — the
    integer layer is not named in ``path``, and ``fn`` sees the whole
    stacked leaf (bijectors apply elementwise; their ``fldj`` sums over
    all dims, which is exactly the total change-of-variables term for
    independent lanes/steps).

    ``gate`` (None = unconditionally live) is the conjunction of branch
    conditions along the way: under a :class:`Switch` node the leaf in
    branch b only exists when ``idx == b``, so bijectors must gate their
    fldj (and domain-sensitive inverses) by it — that is how
    branch-dependent supports work (VERDICT r1 item 8). ``branch`` is
    the STACK of Switch branch indices on the way down, outermost
    first (``PerBranch`` specs peel one layer per wrapped Switch
    level); the same address may be found in several branches, each
    visit gated by its own condition.

    In-place leaf surgery (rather than an overlay merge) keeps the
    choice-map structure identical, so shape-changing bijectors
    (simplex: K-1 ↔ K) never leave stale leaves behind."""
    if isinstance(chm, Indexed):
        new_inner, found = _map_at(chm.inner, path, fn, gate, branch)
        return (
            Indexed(new_inner, chm.idx, chm.n) if found else chm
        ), found
    if not path:
        if isinstance(chm, Choice):
            v = chm.v
            if isinstance(v, Mask):
                new = fn(v.value, _and_gate(gate, v.primal_flag()),
                         branch)
                return Choice(Mask.build(new, v.flag)), True
            return Choice(fn(v, gate, branch)), True
        return chm, False
    if isinstance(chm, Static):
        comp, rest = path[0], path[1:]
        for i, (k, sub) in enumerate(zip(chm.keys, chm.submaps)):
            if k == comp:
                new_sub, found = _map_at(sub, rest, fn, gate, branch)
                if not found:
                    return chm, False
                submaps = (
                    chm.submaps[:i] + (new_sub,) + chm.submaps[i + 1:]
                )
                return Static(submaps, chm.keys), True
        return chm, False
    if isinstance(chm, Or):
        new_left, found = _map_at(chm.left, path, fn, gate, branch)
        if found:
            return Or(new_left, chm.right), True
        new_right, found = _map_at(chm.right, path, fn, gate, branch)
        return (Or(chm.left, new_right) if found else chm), found
    if isinstance(chm, Switch):
        # Out-of-bounds idx CLAMPS (the Switch combinator's documented
        # semantics — tree_choose uses mode='clip'); the liveness gate
        # must agree or an OOB idx would mark every branch dead.
        idx = jnp.clip(
            jnp.asarray(chm.idx), 0, len(chm.branches) - 1
        )
        new_branches = []
        found_any = False
        for b, br in enumerate(chm.branches):
            nb, f = _map_at(
                br, path, fn, _and_gate(gate, idx == b), branch + (b,)
            )
            new_branches.append(nb if f else br)
            found_any = found_any or f
        if not found_any:
            return chm, False
        return Switch(chm.idx, tuple(new_branches)), True
    if isinstance(chm, Filtered):
        # A lazy filter gates existence by the selection: walk the
        # selection along the remaining path and use its check as the
        # liveness flag (descending ungated would let a filtered-out
        # site's fldj leak into the total).
        sel = chm.selection
        for comp in path:
            sel = sel(comp)
        flag = sel.check()
        new_inner, found = _map_at(
            chm.inner, path, fn, _and_gate(gate, flag), branch
        )
        return (
            Filtered(new_inner, chm.selection) if found else chm
        ), found
    if isinstance(chm, (Empty, Choice)):
        return chm, False
    raise NotImplementedError(
        f"Support transforms through {type(chm).__name__} nodes are not "
        "supported."
    )


def _gated_fldj(bij: Bijector, v, gate) -> jax.Array:
    """Sum of ``bij.fldj`` over the lanes where ``gate`` holds.

    ``gate`` is scalar for a plain Switch branch (idx is a scalar) and
    has leading lane dims matching ``v``'s when the branch condition is
    itself batched (vmapped Switch, masked Scan steps)."""
    g = jnp.asarray(gate)
    if g.ndim == 0:
        return jnp.where(g, bij.fldj(v), 0.0)
    f = bij.fldj
    for _ in range(g.ndim):
        f = jax.vmap(f)
    return jnp.sum(jnp.where(g, f(v), 0.0))


def _safe_inverse(bij: Bijector, v, gate):
    """``bij.inverse(v)`` where ``gate`` holds, 0 elsewhere — the inverse
    of a domain-restricted bijector on a dead branch's placeholder value
    can be NaN, so dead lanes are replaced by an in-domain probe value
    (``forward(0)``) before inverting."""
    g = jnp.asarray(gate)
    g_in = jnp.reshape(g, g.shape + (1,) * (jnp.ndim(v) - g.ndim))
    u_shape = jax.eval_shape(bij.inverse, v)
    probe = bij.forward(jnp.zeros(u_shape.shape, u_shape.dtype))
    safe = jnp.where(g_in, v, probe)
    u = bij.inverse(safe)
    g_out = jnp.reshape(g, g.shape + (1,) * (jnp.ndim(u) - g.ndim))
    return jnp.where(g_out, u, 0.0)


def _resolve_spec(spec, branch):
    """``branch``: the Switch branch-index stack (outermost first).
    Each PerBranch layer corresponds to one wrapped Switch level —
    ``infer_transforms`` wraps every level that has any PerBranch
    beneath it, so layers peel contiguously from the outside in."""
    stack = tuple(branch) if branch is not None else ()
    while isinstance(spec, PerBranch):
        if not stack:
            raise ValueError(
                "PerBranch transform spec used at an address that is "
                "not under (enough) Switch nodes."
            )
        spec = spec.specs[stack[0]]
        stack = stack[1:]
    return get_bijector(spec)


def _apply_transforms(chm: ChoiceMap, transforms: dict,
                      direction: str):
    fldj = jnp.zeros(())
    out = chm
    for addr, spec in transforms.items():
        box = []

        def fn(v, gate, branch, spec=spec, box=box):
            bij = _resolve_spec(spec, branch)
            if direction == "forward":
                box.append(
                    bij.fldj(v) if gate is None
                    else _gated_fldj(bij, v, gate)
                )
                return bij.forward(v)
            if gate is None:
                return bij.inverse(v)
            return _safe_inverse(bij, v, gate)

        out, found = _map_at(out, _addr_path(addr), fn)
        if not found:
            raise KeyError(
                f"Transform address {addr!r} not present in choice map."
            )
        # One box entry per visited branch/leaf, each already gated by
        # its own liveness condition — their sum is the total
        # change-of-variables term for this address.
        for j in box:
            fldj = fldj + j
    return out, fldj


def constrain_choices(chm_u: ChoiceMap, transforms: dict):
    """Map the addresses listed in ``transforms`` (flat, nested tuple
    paths, or paths through Scan/Vmap ``Indexed`` layers) from
    unconstrained to constrained values; returns ``(chm_x, sum_fldj)``."""
    return _apply_transforms(chm_u, transforms, "forward")


def unconstrain_choices(chm_x: ChoiceMap, transforms: dict) -> ChoiceMap:
    """Inverse of :func:`constrain_choices` (no Jacobian)."""
    out, _ = _apply_transforms(chm_x, transforms, "inverse")
    return out


def infer_transforms(trace, *, exclude=None) -> dict:
    """Derive a transforms dict automatically from the support metadata of
    the distributions in a (concrete) trace — walks nested ``@gen``
    subtraces; addresses of depth > 1 become tuple keys.

    ``exclude(addr) -> bool`` skips addresses (e.g. observed sites).
    Sites with no support metadata or non-float values are left
    untransformed; ``"simplex"`` maps to the stick-breaking bijector.
    New scope vs the reference (its HMC had no support handling at
    all)."""
    from genjax_xla.lang.combinators.dimap import DimapTrace
    from genjax_xla.lang.combinators.mask import MaskTrace
    from genjax_xla.lang.combinators.scan import ScanTrace
    from genjax_xla.lang.combinators.switch import SwitchTrace
    from genjax_xla.lang.combinators.vmap import VmapTrace
    from genjax_xla.lang.distributions.distribution import DistributionTrace
    from genjax_xla.lang.static import StaticTrace

    out: dict = {}

    def walk(tr, path, sink):
        if isinstance(tr, StaticTrace):
            for addr, sub in zip(tr.addresses, tr.subtraces):
                walk(sub, path + (addr,), sink)
        elif isinstance(tr, (ScanTrace, VmapTrace)):
            # The integer (step/lane) layer is transparent in transform
            # paths — ``_map_at`` descends through the Indexed node and
            # the bijector applies elementwise over the stacked leaf.
            walk(tr.inner, path, sink)
        elif isinstance(tr, (DimapTrace, MaskTrace)):
            # Dimap/Mask preserve the inner choice structure (the mask
            # gate surfaces as a Mask leaf, handled by ``_map_at``).
            walk(tr.inner, path, sink)
        elif isinstance(tr, SwitchTrace):
            # All-branch subtraces: collect supports per branch, merge.
            # Agreeing branches share a plain spec; disagreeing ones get
            # a PerBranch spec so each branch's leaf is transformed by
            # its own bijector, gated by idx == b at apply time
            # (branch-dependent supports, VERDICT r1 item 8). A site
            # recorded as None is present-but-unconstrained — distinct
            # from absent-in-this-branch, which ``_map_at`` never
            # visits.
            per = []
            for sub in tr.subtraces:
                d: dict = {}
                walk(sub, path, d)
                per.append(d)
            # First-seen address order (a set comprehension would make
            # the transforms-dict — and hence the fldj summation order —
            # vary with PYTHONHASHSEED).
            seen: list = []
            for d in per:
                for a in d:
                    if a not in seen:
                        seen.append(a)
            for addr in seen:
                specs = [d.get(addr, _ABSENT) for d in per]
                present = [s for s in specs if s is not _ABSENT]
                nested = any(isinstance(s, PerBranch) for s in present)
                if not nested and all(
                    _spec_equal(s, present[0]) for s in present
                ) and len(present) == len(specs):
                    sink[addr] = present[0]
                else:
                    # Wrap whenever any branch disagrees, is absent, OR
                    # already carries a PerBranch: every Switch level
                    # with a PerBranch beneath gets its own layer, so
                    # resolution peels layers outer-first in lockstep
                    # with the branch-index stack (_resolve_spec).
                    sink[addr] = PerBranch(tuple(
                        None if s is _ABSENT else s for s in specs
                    ))
        elif isinstance(tr, DistributionTrace):
            v = tr.get_retval()
            if isinstance(v, Mask):
                v = v.value
            if not jnp.issubdtype(jnp.result_type(v), jnp.floating):
                return
            spec = tr.get_gen_fn().get_support(*tr.get_args())
            if spec == "unit_interval":
                spec = (0.0, 1.0)
            addr = path[0] if len(path) == 1 else path
            if exclude is not None and exclude(addr):
                return
            # None = present but unconstrained; kept during the walk so
            # Switch merging can tell it apart from an absent site, and
            # dropped from the final dict (identity transform).
            sink[addr] = spec

    walk(trace, (), out)
    return {a: s for a, s in out.items() if s is not None}


def path_present(chm, addr) -> bool:
    """Whether an address (flat or tuple path) resolves to a value in
    ``chm`` — the same Indexed-transparent lookup ``constrain_choices``
    uses. Shared by the observed-site exclusion of ``resolve_transforms``
    and ``enumerative.enumerate_posterior``."""
    _, found = _map_at(
        chm, _addr_path(addr), lambda v, gate, branch: v
    )
    return found


def resolve_transforms(target, transforms):
    """Normalize a ``transforms`` argument shared by the gradient-based
    fitters (``run_nuts``, ``run_svgd``): ``None`` -> ``{}``, a dict
    passes through, ``"auto"`` derives the dict from the target's
    distributions' support metadata with observed addresses excluded."""
    if transforms == "auto":
        import jax as _jax

        from genjax_xla.gfi.choice_map import ChoiceMap as _CM

        probe_tr, _ = target.importance(_jax.random.key(0), _CM.empty())
        probe_latents = target.filter_to_unconstrained(
            probe_tr.get_choices()
        )
        # Exclude any address that does not survive in the latent
        # choice map (i.e. observed sites).
        return infer_transforms(
            probe_tr,
            exclude=lambda addr: not path_present(probe_latents, addr),
        )
    if isinstance(transforms, str):
        raise ValueError(
            f"transforms={transforms!r}: expected a dict, None, or the "
            'string "auto".'
        )
    return transforms or {}
