"""Shared PEP 562 lazy re-export helper for package ``__init__`` files.

Importing ``a.b.c`` executes ``a/__init__`` and ``a/b/__init__`` first,
so one eager re-export in a package init puts its whole submodule (and
everything that submodule imports — jax, flax, orbax) into the
import-time closure of every consumer of every sibling. The packages on
declared-jax-free import paths (``data``, ``score``, ``persist`` — see
graftcheck rule ``import-purity``, docs/ANALYSIS.md) resolve their
re-exports lazily through this helper instead:

    _EXPORTS = {"make_cohort": "synthetic", "shard_rows": "sharding"}
    __all__ = sorted(_EXPORTS)
    __getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)

This module must stay stdlib-only: it is imported by those same
package inits.
"""

from __future__ import annotations


def lazy_exports(module_name: str, exports: dict):
    """Build a module ``__getattr__``/``__dir__`` pair resolving each
    exported name from its submodule on first access (``exports`` maps
    attribute name -> submodule name). Resolved values are cached into
    the package's namespace, so later accesses skip ``__getattr__``."""

    def __getattr__(name: str):
        submodule = exports.get(name)
        if submodule is None:
            raise AttributeError(
                f"module {module_name!r} has no attribute {name!r}"
            )
        import importlib
        import sys

        mod = importlib.import_module(f"{module_name}.{submodule}")
        value = getattr(mod, name)
        setattr(sys.modules[module_name], name, value)
        return value

    def __dir__():
        import sys

        return sorted(
            set(vars(sys.modules[module_name])) | set(exports)
        )

    return __getattr__, __dir__
