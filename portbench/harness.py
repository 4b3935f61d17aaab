"""One run of one cell: set up, measure a window, check the outputs, read
the metrics, and build the result line.

The cell's driver (``drivers/<driver>.py``) makes the inputs from the seed,
builds and warms the program (set-up), runs the measured window, and
compares what the window produced with the plain reference.  The harness
times set-up, guards the imports, keeps the counters and the plan log
around the window, reads every metric the cell reports through its reader
(``metrics/<name>.py``), and orders the line as the contract wants it: the
compared numbers come last.

A driver module has three functions::

    setup(ctx) -> state             inputs, program, warm-up (counted in setup_s)
    window(state, ctx) -> Record    the measured loop
    check(state, record, ctx) -> [ {"name", "value", "limit"} ... ]
                                    after the window, the program's state freed
"""

from __future__ import annotations

import dataclasses
import gc
import math
import sys
import time
from typing import Optional

import torch

from portbench import common, guard
from portbench import trace as trace_lib
from portbench.trace import Trace


@dataclasses.dataclass
class Context:
    cell: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    #: Names of faults to plant in the timed path (the harness's own tests).
    faults: tuple = ()
    #: {"config": {...}, "traffic": {...}} replacing keys of the files (tests at a tiny size).
    overrides: dict = dataclasses.field(default_factory=dict)
    #: Every reading behind the compared numbers, filled by ``check()`` of the cell's driver module (calibration).
    details: dict = dataclasses.field(default_factory=dict)

    @property
    def config(self) -> dict:
        return {**self.cell["config"], **self.overrides.get("config", {})}

    @property
    def traffic(self) -> dict:
        return {**self.cell["workload"]["traffic"], **self.overrides.get("traffic", {})}

    @property
    def check_spec(self) -> dict:
        return {**self.cell["workload"]["check"], **self.overrides.get("check", {})}

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


@dataclasses.dataclass
class Record:
    """What a window produced, for the metric readers."""

    config: dict
    traffic: dict
    window_s: float
    #: One dict per request completed in the window (the driver's fields).
    requests: list
    attempted: int
    failed: int = 0
    #: Kernel launches in the window, by the kernel modules' counter names.
    counters: dict = dataclasses.field(default_factory=dict)
    #: Plans created inside the window (must be none).
    plans: int = 0
    #: The traced slice: its wall seconds (profiler start and stop included).
    slice_s: float = 0.0
    trace: Optional[Trace] = None
    #: (kernel function, bytes handed and returned) of each launch in the slice.
    launches: list = dataclasses.field(default_factory=list)

    def outside_slice(self) -> list:
        return [r for r in self.requests if not r.get("in_slice")]


def launch_counts() -> dict:
    from repro_torch import kernels

    return {k: v for k, v in kernels.counts().items() if not k.endswith("_plain")}


def bracket(record_fn) -> Record:
    """Run ``record_fn()`` (the driver's window) between snapshots of the
    launch counters and the plan log."""
    from repro_torch.core import fft

    before, plans0 = launch_counts(), fft.plan_log()
    record = record_fn()
    after, plans1 = launch_counts(), fft.plan_log()
    record.counters = {k: after[k] - before.get(k, 0) for k in after}
    record.plans = (len(plans1) - len(plans0)) if len(plans0) < fft.PLAN_LOG_MAX else int(plans1 != plans0)
    return record


def read_metrics(entries: list, record: Record, extra: dict) -> dict:
    out = {}
    for m in entries:
        if m["name"] in extra:
            value = extra[m["name"]]
        else:
            value = common.load("metrics", m["name"]).read(record)
        if value is None:  # the reader found nothing to read
            continue
        if not math.isfinite(value):
            raise ValueError(f"metric {m['name']} read {value}")
        out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def device_info(device: torch.device, peak: int) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
                "memory_peak_bytes": peak}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}


def run(cell_name: str, seed: int, seconds: float, trace: bool, *, t_start: float, device=None,
        faults: tuple = (), overrides: Optional[dict] = None, details: Optional[dict] = None) -> dict:
    """One run; returns the result line as a dict (``checks`` last).
    ``details``, when given, receives every reading behind the compared numbers."""
    cell = common.cell(cell_name)
    device = torch.device(device) if device is not None else torch.device("cuda", 0)
    ctx = Context(cell=cell, seed=seed, seconds=seconds, trace=trace, device=device,
                  faults=tuple(faults), overrides=overrides or {},
                  details=details if details is not None else {})
    driver = common.load("drivers", cell["workload"]["driver"])
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    torch.manual_seed(seed)

    state = driver.setup(ctx)
    ctx.sync()
    # Set-up's objects leave the collector's generations, so no collection
    # inside the window walks the model and the inputs again.
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start

    record = bracket(lambda: driver.window(state, ctx))
    guard.check("after the window")
    if record.plans:
        raise RuntimeError(f"{record.plans} plan(s) created inside the window: set-up missed a shape")
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    checks = driver.check(state, record, ctx)
    del state
    correct = bool(checks) and all(c["value"] <= c["limit"] for c in checks) and record.failed == 0

    entries = cell["per_layer"] if trace else cell["end_to_end"]
    metrics = read_metrics(entries, record, {} if trace else {"setup_s": setup_s})
    dev = device_info(device, peak)
    line = {"correct": correct, "attempted": record.attempted, "failed": record.failed,
            "metrics": metrics, "device": dev}
    if trace:
        if record.trace is None:
            raise RuntimeError("a traced run without a traced slice")
        print(f"trace: {record.trace.device_s():.6f} s of device operations in the slice, "
              f"{record.trace.under_prefix(trace_lib.SLICE):.6f} s placed under the host's calls", file=sys.stderr)
        dev["busy_s"] = record.trace.busy_s
        dev["window_s"] = record.trace.window_s
        line["breakdown"] = {"device_ops": record.trace.device_ops(), "idle_gaps": record.trace.idle_gaps()}
    line["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    return line
