"""Lazy package exports (PEP 562).

Each subpackage of the port exports the names its JAX counterpart's
``__init__.py`` exports, but loads a module only when one of its names is
first used: the port's modules import one another across subpackages
(``mapping`` and ``parallel`` through ``pipeline``, ``utils.checkpoint``
through ``mapping``), so eager imports in every ``__init__.py`` would make
cycles, and importing the package builds and loads nothing.
"""

from __future__ import annotations

import importlib


def lazy(package: str, submodules, names: dict):
    """``(__getattr__, __dir__, __all__)`` for ``package``: its
    ``submodules`` by name, and each of ``names`` (name → submodule) from
    its submodule."""

    def __getattr__(name):
        if name in submodules:
            return importlib.import_module(f"{package}.{name}")
        if name in names:
            return getattr(importlib.import_module(f"{package}.{names[name]}"), name)
        raise AttributeError(f"module {package!r} has no attribute {name!r}")

    exported = sorted({*submodules, *names})

    def __dir__():
        return exported

    return __getattr__, __dir__, exported
