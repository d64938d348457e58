"""The package's former import name, kept so existing scripts still run.

``import <this name>.X`` gives the very module object ``lia_ral.X`` (one
module under two names, so classes and state are shared), and
``python -m <this name> <Tool>`` runs the ``lia_ral`` CLI.  New code
imports ``lia_ral``.
"""

import importlib
import importlib.abc
import importlib.util
import sys
import warnings

import lia_ral
from lia_ral import __version__, compile_cache_dir  # noqa: F401

_OLD, _NEW = __name__, lia_ral.__name__
warnings.warn(f"the package {_OLD!r} is now {_NEW!r}; import {_NEW!r}",
              DeprecationWarning, stacklevel=2)


class _Alias(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Serves ``<old>.X`` as the module ``lia_ral.X``."""

    def find_spec(self, fullname, path=None, target=None):
        if (not fullname.startswith(_OLD + ".")
                or fullname == _OLD + ".__main__"):
            return None
        return importlib.util.spec_from_loader(fullname, self)

    def create_module(self, spec):
        module = importlib.import_module(_NEW + spec.name[len(_OLD):])
        # the import system stamps ``spec`` on the module; keep its own
        spec.loader_state = module.__spec__
        return module

    def exec_module(self, module):
        module.__spec__ = module.__spec__.loader_state


if not any(isinstance(f, _Alias) for f in sys.meta_path):
    sys.meta_path.insert(0, _Alias())
