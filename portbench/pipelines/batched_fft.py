"""Batched 1-D complex FFTs through the port, one batch a request.

Each request is one planned ``FFTSpec(n)`` call over a resident (batch, n)
complex64 input (``resident`` of them, a traffic parameter), the paper's
Table 1 measurement: the planner divides the
transform by size (one fused pass up to 65536 points, the two-pass
``cols_pass`` + ``rows_natural`` program beyond).  The inputs are complex
Gaussian, made on the device from the seed; each request's output is kept
as the input's last result.
"""

from __future__ import annotations

import torch

from portbench import spans
from portbench.reference import sar as ref


class Pipeline:
    def __init__(self, config: dict, traffic: dict, device: torch.device, seed: int, faults: tuple = ()):
        from repro_torch.core import fft

        self.inputs = traffic["resident"]
        self.faults = faults
        self.traced = False
        n, batch = config["n"], config["batch"]
        gen = torch.Generator(device=device).manual_seed(seed)
        parts = torch.randn((2, self.inputs, batch, n), generator=gen, device=device)
        self.x = torch.complex(parts[0], parts[1])
        del parts
        self.outputs = [torch.zeros_like(self.x[k]) for k in range(self.inputs)]
        self.plan = fft.plan(fft.FFTSpec(n=n), device=device)
        self.work = n * batch

    def warm(self) -> None:
        self.run(0)

    def run(self, k: int) -> None:
        if "skip_half" in self.faults and k % 2:
            return
        with spans.span("fft", self.traced):
            self.outputs[k] = self.plan(self.x[k])
        if "alter_answer" in self.faults and k == 0:
            self.outputs[k].view(-1)[0] += 0.01 * self.outputs[k].abs().max()

    def release(self) -> None:
        self.plan = None

    def output(self, k: int) -> torch.Tensor:
        return self.outputs[k]

    def reference(self, k: int, precision: str = "float64") -> torch.Tensor:
        return ref.batched_fft(self.x[k], precision)
