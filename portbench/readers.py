"""Readers that several per-layer metrics share (each metric's file names
its own quantity and calls one of these)."""

from __future__ import annotations


def idle_share(record):
    """The share (%) of the traced slice in which no operation ran on the device."""
    trace = record.trace
    if trace is None:
        return None
    return (1.0 - trace.busy_s / trace.window_s) * 100.0


def mean_enqueue_ms(record):
    """The mean of the requests' ``enqueue_ms`` outside the traced slice
    (the profiler's own cost left out)."""
    reqs = record.outside_slice() or record.requests
    return sum(r["enqueue_ms"] for r in reqs) / len(reqs)
