"""Profiling hooks: Perfetto/TensorBoard traces of inference programs via
``jax.profiler`` (new scope — the reference has no profiler, SURVEY §5),
wall-clock timing with device sync, and the persistent compile cache
that the measurement scripts share."""

from __future__ import annotations

import contextlib
import os
import pathlib
import time
from typing import Iterator, Mapping

import jax

__all__ = ["profile_trace", "Timed", "compile_cache_dir", "enable_compile_cache"]

#: Cache directory used when ``JAX_COMPILATION_CACHE_DIR`` is unset: a
#: fixed path inside the checkout (git-ignored), so that every process
#: run from this checkout finds what an earlier one compiled.
DEFAULT_CACHE_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def compile_cache_dir(environ: Mapping[str, str] = os.environ) -> str:
    """Where the persistent compile cache lives: the directory named by
    ``JAX_COMPILATION_CACHE_DIR`` if it is set (JAX reads that variable
    itself), else :data:`DEFAULT_CACHE_DIR`."""
    return environ.get("JAX_COMPILATION_CACHE_DIR") or str(DEFAULT_CACHE_DIR)


def enable_compile_cache(environ: Mapping[str, str] = os.environ) -> str:
    """Turn on JAX's persistent compile cache and return its directory.
    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already uses it and
    nothing is set here; otherwise the cache goes to
    :data:`DEFAULT_CACHE_DIR`."""
    path = compile_cache_dir(environ)
    if not environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    return path


@contextlib.contextmanager
def profile_trace(logdir: str) -> Iterator[None]:
    """Capture a device trace viewable in Perfetto / TensorBoard:

        with profile_trace("/tmp/trace"):
            jax.block_until_ready(run(key))
    """
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class Timed:
    """Wall-clock timing of jitted callables with device sync:

        t = Timed(fn); out = t(args); t.last_s
    """

    def __init__(self, fn):
        self.fn = fn
        self.last_s: float | None = None

    def __call__(self, *args, **kwargs):
        t0 = time.perf_counter()
        out = self.fn(*args, **kwargs)
        jax.block_until_ready(out)
        self.last_s = time.perf_counter() - t0
        return out
