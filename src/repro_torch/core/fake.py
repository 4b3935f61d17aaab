"""The dry run's stand-in for the card: fake tensors and what reads them.

The dry run (:mod:`repro_torch.launch.dryrun`) runs a cell's real step on
``FakeTensor``s under one ``FakeTensorMode``: shapes, dtypes and devices
propagate, nothing is allocated and nothing is computed.  While such a mode
is active (:func:`current`), everything the port resolves for "the card"
resolves to the simulated card instead:

* :func:`card` is the device the fake tensors carry: the host device
  ``cpu``, which under the mode stands for the card.  A fake ``cuda``
  tensor needs a CUDA build (a CPU-only build's autograd engine and Python
  indexing have no CUDA device guard), so the host device keeps the trace
  the same on every host, the card's included;
* :data:`CARD_NAME` and :data:`CARD_SMEM` are the card's name (the tuning
  cache's key) and its per-block shared memory (the planner's budget);
* a kernel wrapper given fake tensors takes :func:`launch`, which counts the
  launch in :data:`LAUNCHES` (a kernel module's ``COUNTS`` count real
  launches only) and reports it to the trace, and builds and loads
  nothing;
* the caches that hold device tensors (:func:`device_cache`) keep their
  fake entries on the mode itself, so a plan or LUT made under it never
  reaches the process-wide cache a later real call reads.

Without an active mode every function here is a no-op check, and a real
tensor never takes the fake branch.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor

__all__ = ["CARD_NAME", "CARD_SMEM", "LAUNCHES", "current", "active", "is_fake", "card", "device_cache",
           "launch", "set_sink"]

#: The simulated card: the H100 the port targets (``torch.cuda.get_device_name``
#: of the SXM part) and its per-block opt-in shared memory (227 KiB,
#: :data:`repro_torch.core.limits.GPU_SMEM_BUDGETS`).
CARD_NAME = "NVIDIA H100 80GB HBM3"
CARD_SMEM = 227 * 1024

#: Traced launches by kernel name (the fake branch's; never a real one's).
LAUNCHES: dict = {}

#: Where :func:`launch` reports a launch: ``sink(name, inputs, outputs, kw)``
#: (the trace in progress), or None.
_SINK: Optional[Callable] = None

#: The dispatcher's slot for the fake mode.
_FAKE_KEY = torch._C._TorchDispatchModeKey.FAKE


def set_sink(sink: Optional[Callable]) -> Optional[Callable]:
    """Install ``sink`` as the launch reporter; returns the previous one."""
    global _SINK
    prev, _SINK = _SINK, sink
    return prev


def current():
    """The active ``FakeTensorMode``, or None: the dispatcher keeps at most
    one, in its own slot, so a real call pays one lookup."""
    return torch._C._get_dispatch_mode(_FAKE_KEY)


def active() -> bool:
    return current() is not None


def is_fake(t) -> bool:
    return isinstance(t, FakeTensor)


def card() -> torch.device:
    """The device the dry run's fake tensors carry for the card."""
    return torch.device("cpu")


def device_cache(maxsize: int):
    """``functools.lru_cache(maxsize)`` for a function that makes device
    tensors, except under an active fake mode, where the entries live in a
    dict on the mode (and die with it)."""

    def wrap(fn):
        cached = functools.lru_cache(maxsize=maxsize)(fn)

        @functools.wraps(fn)
        def call(*args, **kwargs):
            mode = current()
            if mode is None:
                return cached(*args, **kwargs)
            memo = mode.__dict__.setdefault("_repro_device_cache", {})
            key = (fn.__module__, fn.__qualname__, args, tuple(sorted(kwargs.items())))
            if key not in memo:
                memo[key] = fn(*args, **kwargs)
            return memo[key]

        call.cache_clear = cached.cache_clear
        call.cache_info = cached.cache_info
        return call

    return wrap


def launch(name: str, inputs, outputs, scratch=(), **kw) -> bool:
    """The fake branch of a kernel launch: True (the launch is counted in
    :data:`LAUNCHES` and reported to the trace) when the tensors are fake,
    False when none is.  ``inputs`` (signal planes and LUTs), ``outputs``
    and ``scratch`` are the launch's tensors, already allocated (None
    entries skipped); ``kw`` what the launch's flops depend on.  A mix of
    fake and real tensors raises: a fake tensor has nothing to compute and
    a real one nothing to trace."""
    ts = [t for t in (*inputs, *outputs, *scratch) if t is not None]
    fake = [is_fake(t) for t in ts]
    if not any(fake):
        return False
    if not all(fake):
        from repro_torch.core.faults import PlanError

        raise PlanError(f"{name}: fake and real tensors in one launch")
    LAUNCHES[name] = LAUNCHES.get(name, 0) + 1
    if _SINK is not None:
        _SINK(name, [t for t in inputs if t is not None], [t for t in outputs if t is not None], kw)
    return True
