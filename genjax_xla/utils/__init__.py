"""Utilities: checkpointing, failure recovery, pretty rendering,
profiling hooks."""

from genjax_xla.utils.checkpoint import restore_checkpoint, save_checkpoint
from genjax_xla.utils.failure import (
    ElasticResult,
    FailureEvent,
    Watchdog,
    all_finite,
    run_elastic,
)
from genjax_xla.utils.pretty import (
    pformat,
    pretty,
    pprint,
    render_choice_map,
    render_html,
)

__all__ = [
    "ElasticResult",
    "FailureEvent",
    "Watchdog",
    "all_finite",
    "run_elastic",
    "pformat",
    "pretty",
    "pprint",
    "render_choice_map",
    "render_html",
    "restore_checkpoint",
    "save_checkpoint",
]
