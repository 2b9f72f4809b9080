"""genjax_xla: probabilistic programming with programmable inference for
accelerators, built on JAX / XLA / pjit / shard_map.

Public facade. Functional parity target: ``/root/reference/src/genjax/
__init__.py`` (the Gen generative function interface, distributions,
combinators, and inference library), re-architected for compiled,
batched execution.
"""

from genjax_xla.core.checks import do_checkify, optional_check
from genjax_xla.core.pytree import Closure, Const, Pytree, PythonicPytree
from genjax_xla.core.compiler.staging import (
    FlagOp,
    empty_trace,
    multi_switch,
    stage,
    to_shape_fn,
    tree_choose,
)
from genjax_xla.core.compiler.interpreters.incremental import (
    Diff,
    NoChange,
    UnknownChange,
    incremental,
)
from genjax_xla.gfi.choice_map import (
    C,
    ChoiceMap,
    ChoiceMapBuilder,
    ChoiceMapNoValueAtAddress,
)
from genjax_xla.gfi.concepts import (
    Argdiffs,
    EditRequest,
    IndexRequest,
    NotSupportedEditRequest,
    PrimitiveEditRequest,
    Retdiff,
    Score,
    Weight,
)
from genjax_xla.gfi.gfn import (
    GenerativeFunction,
    GenerativeFunctionClosure,
    Trace,
)
from genjax_xla.gfi.mask import Mask
from genjax_xla.gfi.requests import (
    DiffAnnotate,
    EmptyRequest,
    Regenerate,
    Update,
)
from genjax_xla.gfi.selection import Selection
from genjax_xla.lang.static import (
    AddressReuse,
    Fn,
    MissingAddress,
    StaticRequest,
    StaticTrace,
    gen,
)
from genjax_xla.lang.distributions import *  # noqa: F401,F403
from genjax_xla.lang.distributions import __all__ as _dist_all
from genjax_xla.lang.combinators import *  # noqa: F401,F403
from genjax_xla.lang.combinators import __all__ as _comb_all

# Subpackage re-exports for `g.inference...` style access.
from genjax_xla import adev, inference, models, ops, parallel, utils  # noqa: E402,F401

#: ``S`` — the selection builder: ``S["x"]``, ``S.all()``, ...
S = Selection

__version__ = "0.1.0"

__all__ = [
    "AddressReuse",
    "adev",
    "inference",
    "models",
    "ops",
    "parallel",
    "utils",
    "Argdiffs",
    "C",
    "ChoiceMap",
    "ChoiceMapBuilder",
    "ChoiceMapNoValueAtAddress",
    "Closure",
    "Const",
    "Diff",
    "DiffAnnotate",
    "EditRequest",
    "EmptyRequest",
    "Fn",
    "FlagOp",
    "GenerativeFunction",
    "GenerativeFunctionClosure",
    "IndexRequest",
    "Mask",
    "MissingAddress",
    "NoChange",
    "NotSupportedEditRequest",
    "PrimitiveEditRequest",
    "Pytree",
    "PythonicPytree",
    "Regenerate",
    "Retdiff",
    "S",
    "Score",
    "Selection",
    "StaticRequest",
    "StaticTrace",
    "Trace",
    "UnknownChange",
    "Update",
    "Weight",
    "do_checkify",
    "empty_trace",
    "gen",
    "incremental",
    "multi_switch",
    "optional_check",
    "stage",
    "to_shape_fn",
    "tree_choose",
    *_dist_all,
    *_comb_all,
]
