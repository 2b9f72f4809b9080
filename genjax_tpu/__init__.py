"""Deprecated alias of :mod:`genjax_xla`, the package's current name.

Importing this package, or any submodule under it, warns once and hands
back the very module objects of ``genjax_xla``: classes, registries and
pytree types are shared, so code that mixes old and new imports still
agrees on ``isinstance`` and on tree structure."""

import importlib
import importlib.abc
import importlib.util
import sys
import warnings

_NEW = "genjax_xla"
_OLD = __name__


class _AliasFinder(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Resolves ``<old>.x.y`` to the already-importable ``genjax_xla.x.y``."""

    def find_spec(self, fullname, path=None, target=None):
        if fullname.startswith(_OLD + "."):
            return importlib.util.spec_from_loader(fullname, self)
        return None

    def create_module(self, spec):
        return importlib.import_module(_NEW + spec.name[len(_OLD):])

    def exec_module(self, module):
        pass


warnings.warn(
    f"{_OLD} has been renamed {_NEW}; import {_NEW} instead",
    DeprecationWarning,
    stacklevel=2,
)
sys.meta_path.insert(0, _AliasFinder())
sys.modules[_OLD] = importlib.import_module(_NEW)
