"""Typed failures and deterministic fault injection.

Port of ``src/repro/core/faults.py``: the ``ReproError`` taxonomy and the named
fault-injection sites, unchanged.

What is deliberately *not* ported is the reference's ``run_leaf`` retry →
quarantine → fallback-to-XLA protocol.  On the card a kernel that fails to
build or launch raises a typed :class:`KernelError` and the call fails; no
path gives way to the plain PyTorch version or to the CPU, so a result
always says which code produced it.

Everything here is host-side Python.
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
from typing import Dict, Optional, Tuple

__all__ = [
    "ReproError",
    "PlanError",
    "KernelError",
    "TuningCacheError",
    "CollectiveError",
    "ServeError",
    "NumericsError",
    "SITES",
    "inject_fault",
    "maybe_fail",
    "arm_env_faults",
    "fault_counters",
    "clear_faults",
]


# ---------------------------------------------------------------------------
# error taxonomy
# ---------------------------------------------------------------------------


class ReproError(Exception):
    """Base of every typed error the engine raises on purpose.

    Context (``site`` / ``spec`` / ``backend`` / ``pass_kind`` and any
    extra keyword pairs) is kept as attributes and appended to the
    message so a bare traceback names the failing plan, not just a line.
    """

    def __init__(
        self,
        message: str = "",
        *,
        site: Optional[str] = None,
        spec=None,
        backend: Optional[str] = None,
        pass_kind: Optional[str] = None,
        injected: bool = False,
        **context,
    ):
        self.site = site
        self.spec = spec
        self.backend = backend
        self.pass_kind = pass_kind
        self.injected = injected
        self.context = dict(context)
        bits = []
        for key, val in (
            ("site", site),
            ("spec", spec),
            ("backend", backend),
            ("pass", pass_kind),
        ):
            if val is not None:
                bits.append(f"{key}={val!r}" if not isinstance(val, str) else f"{key}={val}")
        bits.extend(f"{k}={v!r}" for k, v in self.context.items())
        if injected:
            bits.append("injected")
        super().__init__(message + (f" [{', '.join(bits)}]" if bits else ""))


class PlanError(ReproError, ValueError):
    """Invalid spec, unknown backend, failed negotiation, bad plan input."""


class KernelError(ReproError, RuntimeError):
    """A CUDA kernel failed to build or launch."""


class TuningCacheError(ReproError, RuntimeError):
    """The persistent tuning cache could not be read or written."""


class CollectiveError(ReproError, RuntimeError):
    """A pencil collective (all-to-all) failed."""


class ServeError(ReproError, ValueError, RuntimeError):
    """A serve phase failed or a request was rejected (backpressure)."""


class NumericsError(ReproError, ArithmeticError):
    """An opt-in numerics guard (check="nan"/"parseval") tripped."""


# ---------------------------------------------------------------------------
# fault-injection registry
# ---------------------------------------------------------------------------

#: The named sites compiled into the engine.  Arming any other name is a
#: PlanError — chaos configs fail fast instead of silently never firing.
SITES: Tuple[str, ...] = (
    "kernel.launch",
    "tuning.cache_read",
    "tuning.cache_write",
    "pencil.all_to_all",
    "serve.prefill",
    "serve.insert",
    "serve.generate",
)

_SITE_EXC: Dict[str, type] = {
    "kernel.launch": KernelError,
    "tuning.cache_read": TuningCacheError,
    "tuning.cache_write": TuningCacheError,
    "pencil.all_to_all": CollectiveError,
    "serve.prefill": ServeError,
    "serve.insert": ServeError,
    "serve.generate": ServeError,
}

_LOCK = threading.Lock()
_ARMED: Dict[str, dict] = {}
_FIRED: collections.Counter = collections.Counter()
_ENV_PARSED = False


def _check_site(site: str) -> None:
    if site not in SITES:
        raise PlanError(
            f"unknown fault site {site!r}; registered sites: {', '.join(SITES)}"
        )


def arm_env_faults(force: bool = False) -> None:
    """Parse ``REPRO_FAULTS`` (comma list of ``site`` or ``site:times``).

    Runs once lazily on the first ``maybe_fail``; ``force=True`` re-reads
    the environment (tests).
    """
    global _ENV_PARSED
    if _ENV_PARSED and not force:
        return
    _ENV_PARSED = True
    raw = os.environ.get("REPRO_FAULTS", "")
    for item in (s.strip() for s in raw.split(",")):
        if not item:
            continue
        site, _, times = item.partition(":")
        _check_site(site)
        n = int(times) if times else 1
        with _LOCK:
            _ARMED[site] = {"remaining": n, "exc": _SITE_EXC[site]}


@contextlib.contextmanager
def inject_fault(site: str, *, times: int = 1, exc: Optional[type] = None):
    """Arm ``site`` to raise its typed error the next ``times`` hits.

    Deterministic: exactly the next ``times`` executions of the site fail,
    then the site reverts to whatever arming it had before the block.
    """
    _check_site(site)
    with _LOCK:
        prev = _ARMED.get(site)
        _ARMED[site] = {"remaining": times, "exc": exc or _SITE_EXC[site]}
    try:
        yield
    finally:
        with _LOCK:
            if prev is None:
                _ARMED.pop(site, None)
            else:
                _ARMED[site] = prev


def maybe_fail(site: str, **context) -> None:
    """The hook compiled into each fault site.  No-op unless armed."""
    arm_env_faults()
    if site not in _ARMED:  # fast path: plain dict probe, no lock
        return
    with _LOCK:
        armed = _ARMED.get(site)
        if not armed or armed["remaining"] <= 0:
            return
        armed["remaining"] -= 1
        _FIRED[site] += 1
        exc = armed["exc"]
    raise exc(f"injected fault at {site}", site=site, injected=True, **context)


def fault_counters() -> Dict[str, int]:
    """How many times each site has fired (injected faults only)."""
    return dict(_FIRED)


def clear_faults() -> None:
    """Disarm every site and zero the fired counters (tests)."""
    global _ENV_PARSED
    with _LOCK:
        _ARMED.clear()
        _FIRED.clear()
        _ENV_PARSED = True  # a cleared state stays cleared; force re-arm explicitly
