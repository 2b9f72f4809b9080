"""The modeling language layer: the ``@gen`` DSL, distributions, and
combinators."""

from genjax_xla.lang.static import (
    AddressReuse,
    Fn,
    MissingAddress,
    StaticRequest,
    StaticTrace,
    gen,
)

__all__ = [
    "AddressReuse",
    "Fn",
    "MissingAddress",
    "StaticRequest",
    "StaticTrace",
    "gen",
]
