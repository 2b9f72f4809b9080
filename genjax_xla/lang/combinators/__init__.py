"""Combinators: structured composition of generative functions."""

from genjax_xla.lang.combinators.dimap import (
    Dimap,
    DimapTrace,
    contramap,
    dimap,
    map_retval,
)
from genjax_xla.lang.combinators.mask import MaskCombinator, MaskTrace, mask
from genjax_xla.lang.combinators.mixture import mix
from genjax_xla.lang.combinators.or_else import OrElse, or_else
from genjax_xla.lang.combinators.repeat import repeat
from genjax_xla.lang.combinators.scan import (
    Scan,
    ScanTrace,
    accumulate,
    iterate,
    iterate_final,
    masked_iterate,
    masked_iterate_final,
    prepend_initial_acc,
    reduce,
    scan,
)
from genjax_xla.lang.combinators.switch import Switch, SwitchTrace, switch
from genjax_xla.lang.combinators.vmap import Vmap, VmapTrace, vmap

__all__ = [
    "Dimap",
    "DimapTrace",
    "MaskCombinator",
    "MaskTrace",
    "OrElse",
    "Scan",
    "ScanTrace",
    "Switch",
    "SwitchTrace",
    "Vmap",
    "VmapTrace",
    "accumulate",
    "contramap",
    "dimap",
    "iterate",
    "iterate_final",
    "map_retval",
    "mask",
    "masked_iterate",
    "masked_iterate_final",
    "mix",
    "or_else",
    "prepend_initial_acc",
    "reduce",
    "repeat",
    "scan",
    "switch",
    "vmap",
]
