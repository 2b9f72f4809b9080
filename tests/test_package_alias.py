"""The package's former name stays importable as a deprecated alias of
``genjax_xla`` (a top-level package of the checkout whose only job is
to forward there)."""

import importlib
import os
import subprocess
import sys
import warnings

import pytest

import genjax_xla

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ALIASES = sorted(
    name for name in os.listdir(ROOT)
    if name.startswith("genjax_") and name != "genjax_xla"
    and os.path.isfile(os.path.join(ROOT, name, "__init__.py"))
)


def test_alias_package_exists():
    assert ALIASES


@pytest.mark.parametrize("alias", ALIASES)
def test_alias_is_the_same_package(alias):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        mod = importlib.import_module(alias)
    assert mod is genjax_xla
    smc = importlib.import_module(alias + ".inference.smc")
    from genjax_xla.inference import smc as smc_new

    assert smc is smc_new
    assert importlib.import_module(alias + ".parallel").sharded_smc_step \
        is genjax_xla.parallel.sharded_smc_step


@pytest.mark.parametrize("alias", ALIASES)
def test_alias_import_warns(alias):
    code = (
        "import warnings; warnings.simplefilter('error', DeprecationWarning)\n"
        f"try:\n    import {alias}\nexcept DeprecationWarning as e:\n"
        "    print('warned:', e)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=ROOT, env=dict(os.environ, JAX_PLATFORMS="cpu"), timeout=120,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "warned:" in out.stdout and "genjax_xla" in out.stdout
