"""One-time DeprecationWarnings for the port's deprecated options.

The port's own copy of ``repro.core._deprecated``: each deprecated
option (``plan(use_kernel=)``) calls :func:`warn_once` naming its
replacement, and the warning fires once per process per name.
"""
from __future__ import annotations

import warnings

_seen: set = set()


def warn_once(name: str, replacement: str) -> None:
    """Emit one DeprecationWarning per process for ``name``, telling
    callers to use ``replacement``."""
    if name in _seen:
        return
    _seen.add(name)
    warnings.warn(f"{name} is deprecated; use {replacement} instead",
                  DeprecationWarning, stacklevel=2)


def reset(name: str) -> None:
    """Forget that ``name`` warned, so a test can see the warning fire."""
    _seen.discard(name)
