"""The import guard: the benchmark measures the port and never loads JAX.

A module counts by its top-level name, the part before the first dot,
compared whole: ``repro_torch`` is the port and passes, ``repro`` (the JAX
package), ``jax``, ``jaxlib`` and ``flax`` do not.
"""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def top_level(name: str) -> str:
    return name.partition(".")[0]


def forbidden(names=None) -> list:
    """The forbidden top-level names among ``names`` (default: every module
    this process has loaded), sorted."""
    names = sys.modules if names is None else names
    return sorted({top_level(n) for n in names} & set(FORBIDDEN))


def check(when: str) -> None:
    """Raise when this process has loaded a forbidden module."""
    found = forbidden()
    if found:
        raise ImportError(f"{when}: the benchmark process has loaded {found}; it measures the port "
                          "(repro_torch) and must not load JAX or the JAX package")
