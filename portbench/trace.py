"""The traced slice of a ``--trace 1`` run: ``torch.profiler`` over a steady
part of the window, reduced to what the per-layer readers need.

Spans are ``record_function`` ranges named ``pb.*`` that the benchmark's own
files put around calls into the port (:mod:`portbench.spans`).  The slice
is itself a range, ``pb.slice``, opened after a synchronise and closed after
another, so every device operation it covers was launched inside it.

From the profiler's events:

* ``kernels`` — every device operation (kernels, copies, fills), with its
  start and end in microseconds; the device-side copies of the ranges are
  left out;
* ``ranges`` — every ``pb.*`` range on the host;
* ``under`` — for each range name, the device microseconds of the
  operations launched while the host was inside such a range.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import time
from typing import Optional

import torch

from portbench import spans

PREFIX = "pb."
SLICE = "pb.slice"


@dataclasses.dataclass
class Trace:
    window: tuple            # (start µs, end µs) of the slice
    kernels: list            # (name, start µs, end µs)
    ranges: list             # (name, start µs, end µs)
    under: dict              # range name → device µs launched under it

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def intervals(self) -> list:
        """The device's busy intervals inside the slice, merged."""
        t0, t1 = self.window
        spans = sorted((max(s, t0), min(e, t1)) for _, s, e in self.kernels if e > t0 and s < t1)
        merged = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.intervals()) / 1e6

    def under_prefix(self, prefix: str) -> float:
        """Device seconds launched under every range whose name starts with ``prefix``."""
        return sum(us for name, us in self.under.items() if name.startswith(prefix)) / 1e6

    def device_s(self) -> float:
        """Device seconds of every operation in the slice (overlaps counted twice)."""
        t0, t1 = self.window
        return sum(min(e, t1) - max(s, t0) for _, s, e in self.kernels if e > t0 and s < t1) / 1e6

    def device_ops(self, top: int = 10) -> list:
        """[name, seconds] of the device operations that took most time."""
        by = {}
        for name, s, e in self.kernels:
            by[name] = by.get(name, 0.0) + (e - s) / 1e6
        return [[name[:160], sec] for name, sec in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """[host span, seconds]: the device's idle time in the slice, summed by
        the innermost ``pb.*`` range the host was in when each gap began."""
        t0, t1 = self.window
        gaps, at = [], t0
        for s, e in self.intervals():
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        if t1 > at:
            gaps.append((at, t1))
        inner = sorted((r for r in self.ranges if r[0] != SLICE), key=lambda r: r[1])
        starts = [r[1] for r in inner]
        longest = max((r[2] - r[1] for r in inner), default=0.0)
        by = {}
        for g0, g1 in gaps:
            # The innermost range holding g0 is the latest-starting one that
            # has not ended by then; none starts earlier than the longest
            # range's length before g0.
            name = "outside pb spans"
            for i in range(bisect.bisect_right(starts, g0) - 1, -1, -1):
                if inner[i][1] < g0 - longest:
                    break
                if inner[i][2] >= g0:
                    name = inner[i][0]
                    break
            by[name] = by.get(name, 0.0) + (g1 - g0) / 1e6
        return [[name, sec] for name, sec in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def reduce(prof) -> Trace:
    """The :class:`Trace` of a finished ``torch.profiler.profile``.

    Each device operation shares its correlation id with the runtime call
    that launched it on the host; that call's time places it inside the
    ``pb.*`` ranges open on the host thread then, whatever launched it (an
    aten op, cuBLAS, or the port's kernels through ``ctypes``)."""
    kernels, ranges, calls, device_us = [], [], [], {}
    window, thread = None, None
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not e.name.startswith(PREFIX) and not getattr(e, "is_user_annotation", False):
                kernels.append((e.name, start, end))
                device_us[e.id] = device_us.get(e.id, 0.0) + (end - start)
        elif e.name.startswith(PREFIX):
            ranges.append((e.name, start, end, e.thread))
            if e.name == SLICE:
                window, thread = (start, end), e.thread
        elif e.name.startswith("cu"):  # a CUDA runtime or driver call: cudaLaunchKernel, cudaMemcpyAsync, ...
            calls.append((start, e.id, e.thread))
    if window is None:
        raise RuntimeError(f"the trace holds no {SLICE!r} range")
    ranges = [r for r in ranges if r[3] == thread]
    # One sweep in time: the ranges (properly nested on one thread) open at
    # each launching call are a stack.
    under, stack, i = {}, [], 0
    ordered = sorted(ranges, key=lambda r: (r[1], -r[2]))
    for at, corr, th in sorted(c for c in calls if c[2] == thread):
        while i < len(ordered) and ordered[i][1] <= at:
            while stack and stack[-1][2] < ordered[i][1]:
                stack.pop()
            stack.append(ordered[i])
            i += 1
        while stack and stack[-1][2] < at:
            stack.pop()
        us = device_us.get(corr, 0.0)
        if us:
            for name in {r[0] for r in stack}:
                under[name] = under.get(name, 0.0) + us
    return Trace(window=window, kernels=kernels, ranges=[r[:3] for r in ranges], under=under)


class Tracer:
    """The traced slice of a window: starts the profiler, the ``pb.slice``
    range and the kernel launches' record (:class:`spans.KernelLaunches`,
    installed for the window) at ``frac`` of the window, and stops them
    ``length`` seconds later; does nothing when ``enabled`` is false."""

    def __init__(self, enabled: bool, device: torch.device):
        self.enabled, self.device = enabled, device
        self.launches = spans.KernelLaunches()
        self.trace: Optional[Trace] = None
        self.active = self.done = False
        #: Wall seconds of the slice, the profiler's start and stop included.
        self.slice_s = 0.0
        self._prof = self._range = None
        self._at = self._length = self._t_slice = 0.0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        return profile(activities=activities)

    def warm(self) -> None:
        """Start and stop the profiler once (set-up), so that starting the
        slice later costs the window little."""
        if self.enabled:
            with self._profile():
                torch.zeros(1, device=self.device).add_(1)
                self._sync()

    @contextlib.contextmanager
    def window(self, seconds: float, frac: float, length: float):
        """Around a driver's measured loop of ``seconds``."""
        self._at, self._length = time.perf_counter() + frac * seconds, length
        if self.enabled:
            self.launches.install()
        try:
            yield self
        finally:
            self.launches.remove()

    def due(self) -> bool:
        """Whether the slice is to start or stop now."""
        return self.enabled and not self.done and time.perf_counter() >= self._at

    def toggle(self) -> None:
        """Start the slice, or stop it (the caller has drained the device
        where it keeps work in flight)."""
        from torch.profiler import record_function

        if not self.active:
            self._t_slice = time.perf_counter()
            self._sync()
            self._prof = self._profile()
            self._prof.start()
            self._range = record_function(SLICE)
            self._range.__enter__()
            self.active = self.launches.active = True
            self._at = time.perf_counter() + self._length
            return
        self._sync()
        self._range.__exit__(None, None, None)
        self._prof.stop()
        self.active = self.launches.active = False
        self.done = True
        self.trace = reduce(self._prof)
        self._prof = self._range = None
        self.slice_s += time.perf_counter() - self._t_slice

    def finish(self) -> None:
        """Stop a slice the window's end found running."""
        if self.active:
            self.toggle()
