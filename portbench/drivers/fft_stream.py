"""A closed loop of FFT requests over inputs resident on the device.

The traffic gives ``ahead`` (requests dispatched ahead of the device),
``check_sample`` (how many inputs' last outputs are compared after the
window) and ``trace_slice`` ([start as a share of the window, seconds]).
The pipeline (``pipelines/<pipeline>.py``, class ``Pipeline(config,
traffic, device, seed, faults)``) makes ``inputs`` inputs from the seed,
each of ``work`` samples; ``warm()`` builds every plan and kernel,
``run(k)`` sends input k through the port into its output buffer,
``release()`` drops the program's state, and ``output(k)`` and
``reference(k, precision)`` give what is compared.

Each request's span on the device runs from a CUDA event recorded before
its first call to one recorded after its last; the host's enqueue time is
the host clock around the same calls, with no synchronise.  When ``ahead``
requests are in flight, the loop waits for the oldest.  The window closes
at ``--seconds``: nothing more is dispatched, and it ends when the last
request dispatched has completed, so every request counted lies in it.
"""

from __future__ import annotations

import collections
import random
import time

import torch

from portbench import common, compare, spans
from portbench.harness import Record
from portbench.trace import Tracer


class HostEvent:
    """A CUDA event's interface on the host clock (the CPU route, where
    every call returns when its work is done)."""

    def record(self) -> None:
        self.t = time.perf_counter()

    def synchronize(self) -> None:
        pass

    def elapsed_time(self, end: "HostEvent") -> float:
        return (end.t - self.t) * 1e3


def event(device: torch.device):
    return torch.cuda.Event(enable_timing=True) if device.type == "cuda" else HostEvent()


def setup(ctx) -> dict:
    pipeline = common.load("pipelines", ctx.cell["workload"]["pipeline"])
    pipe = pipeline.Pipeline(ctx.config, ctx.traffic, ctx.device, ctx.seed, faults=ctx.faults)
    pipe.warm()
    tracer = Tracer(ctx.trace, ctx.device)
    tracer.warm()
    return {"pipe": pipe, "tracer": tracer}


def window(state: dict, ctx) -> Record:
    pipe, tracer = state["pipe"], state["tracer"]
    depth, n_inputs = ctx.traffic["ahead"], pipe.inputs
    traced = pipe.traced = ctx.trace
    requests, inflight = [], collections.deque()
    issued = 0

    def complete() -> None:
        k, start, end, enqueue_ms, in_slice = inflight.popleft()
        with spans.span("wait", traced):
            end.synchronize()
        requests.append({"input": k, "work": pipe.work, "span_ms": start.elapsed_time(end),
                         "enqueue_ms": enqueue_ms, "in_slice": in_slice})

    with tracer.window(ctx.seconds, *ctx.traffic["trace_slice"]):
        t0 = time.perf_counter()
        deadline = t0 + ctx.seconds
        while True:
            if tracer.due():  # the slice starts and ends drained: it holds its own requests whole
                while inflight:
                    complete()
                tracer.toggle()
            if time.perf_counter() >= deadline:
                break
            if len(inflight) >= depth:
                complete()
            k = issued % n_inputs
            start, end = event(ctx.device), event(ctx.device)
            h0 = time.perf_counter()
            with spans.span("request", traced):
                start.record()
                pipe.run(k)
                end.record()
            inflight.append((k, start, end, (time.perf_counter() - h0) * 1e3, tracer.active))
            issued += 1
        while inflight:
            complete()
        tracer.finish()
        window_s = time.perf_counter() - t0
    return Record(config=ctx.config, traffic=ctx.traffic, window_s=window_s, requests=requests, attempted=issued,
                  slice_s=tracer.slice_s, trace=tracer.trace, launches=tracer.launches.launches)


def check(state: dict, record: Record, ctx) -> list:
    """Each sampled input's last output against the reference, after the
    program's working state is released; the worst reading is compared."""
    pipe = state["pipe"]
    pipe.release()
    done = sorted({r["input"] for r in record.requests})
    sample = random.Random(ctx.seed).sample(done, min(ctx.traffic["check_sample"], len(done)))
    (name, limit), = ctx.check_spec["limits"].items()
    readings = [compare.rel_max(pipe.output(k), pipe.reference(k)) for k in sorted(sample)]
    ctx.details[name] = readings
    return [compare.judged(name, readings, limit)]


def control(ctx) -> dict:
    """The control's readings: the reference at the next precision down
    (``precision="bfloat16"``) in the program's place, on the inputs of
    ``ctx.seed``, compared as :func:`check` compares the program."""
    pipeline = common.load("pipelines", ctx.cell["workload"]["pipeline"])
    pipe = pipeline.Pipeline(ctx.config, ctx.traffic, ctx.device, ctx.seed)
    pipe.release()
    sample = random.Random(ctx.seed).sample(range(pipe.inputs), min(ctx.traffic["check_sample"], pipe.inputs))
    (name, _), = ctx.check_spec["limits"].items()
    return {name: [compare.rel_max(pipe.reference(k, "bfloat16"), pipe.reference(k)) for k in sorted(sample)]}
