"""Fault-tolerance runtime: step watchdog, retry wrapper, straggler stats.

Port of ``repro/runtime/fault_tolerance.py`` (plain Python, the same for
both packages; CUDA errors surface as ``RuntimeError`` as XLA's do).

On a 1000+-node pod the failure modes are (a) hard node loss — handled by
checkpoint/restart (see checkpoint.manager), (b) hangs /
stragglers — handled here:

* :class:`StepWatchdog` — a monitor thread that fires a callback if a step
  exceeds ``timeout``; the launcher's default callback logs, snapshots, and
  raises in the main thread so the supervisor restarts from the last
  checkpoint (crash-only design).
* :func:`with_retries` — retries transient device errors with backoff and
  re-initialisation hooks.
* :class:`StragglerStats` — EWMA of step times; flags steps slower than
  ``k·ewma`` (on real pods: feeds the controller that re-shards around slow
  hosts; offline: surfaces in metrics/logs).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

__all__ = ["StepWatchdog", "with_retries", "StragglerStats"]


class StepWatchdog:
    def __init__(self, timeout_s: float, on_timeout: Optional[Callable[[], None]] = None):
        self.timeout = timeout_s
        self.on_timeout = on_timeout or (lambda: None)
        self._deadline: Optional[float] = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self.fired = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def arm(self):
        with self._lock:
            self._deadline = time.monotonic() + self.timeout

    def disarm(self):
        with self._lock:
            self._deadline = None

    def _run(self):
        while not self._stop.wait(min(self.timeout / 4, 1.0)):
            with self._lock:
                dl = self._deadline
            if dl is not None and time.monotonic() > dl:
                self.fired = True
                self._deadline = None
                self.on_timeout()

    def close(self):
        self._stop.set()


def with_retries(fn, *, retries: int = 3, backoff_s: float = 1.0, on_retry=None):
    """Run ``fn()`` retrying transient failures with linear backoff."""
    last = None
    for attempt in range(retries + 1):
        try:
            return fn()
        except (RuntimeError, OSError) as e:  # device errors surface as RuntimeError
            last = e
            if attempt == retries:
                raise
            if on_retry:
                on_retry(attempt, e)
            time.sleep(backoff_s * (attempt + 1))
    raise last  # unreachable


class StragglerStats:
    """EWMA step-time tracker with straggler flagging."""

    def __init__(self, alpha: float = 0.1, threshold: float = 2.0):
        self.alpha = alpha
        self.threshold = threshold
        self.ewma: Optional[float] = None
        self.flagged = 0
        self.total = 0

    def record(self, dt: float) -> bool:
        """Returns True if this step is a straggler."""
        self.total += 1
        if self.ewma is None:
            self.ewma = dt
            return False
        slow = dt > self.threshold * self.ewma
        if slow:
            self.flagged += 1
        # EWMA excludes extreme outliers so one hang doesn't poison the mean.
        if dt < 4 * self.ewma:
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return slow

    def summary(self) -> dict:
        return {"ewma_s": self.ewma, "stragglers": self.flagged, "steps": self.total}
