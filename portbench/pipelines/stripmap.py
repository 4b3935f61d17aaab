"""Stripmap SAR image formation through the port, one azimuth block a request.

Per block (``n_az`` echo lines × ``n_rg`` complex range samples, held as
float32 I and Q planes): range compression by the port's planned complex
FFT of each line at the next power of two past ``n_rg + chirp_len − 1``,
the product with the chirp replica's conjugate spectrum, and the planned
inverse, keeping the leading ``n_rg`` samples; azimuth compression by the
planned ``FFTSpec(n_az, kind="fft", axis=-2)`` down the columns; and the
magnitude, written into the block's resident image buffer.  The replica's
spectrum is made once, in set-up, through the same forward plan.

The blocks are made on the device from the seed, all at once: complex
Gaussian noise of standard deviation ``noise`` a component and, per target
(azimuth frequency in cycles a line, range offset scaled from
``targets_at_n_rg``), the replica delayed to its range offset under a
complex azimuth tone, at an amplitude drawn per block from U(0.5, 1.5).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as tF

from portbench import spans
from portbench.reference import sar as ref


def replica(config: dict, device) -> torch.Tensor:
    """The (chirp_len,) complex64 linear FM pulse, swept over the chirp's
    bandwidth centred on zero, at the range sampling rate (phase in float64)."""
    lh, fs = config["chirp_len"], config["range_sampling_hz"]
    rate = config["chirp_bandwidth_hz"] / config["chirp_s"]
    t = (torch.arange(lh, dtype=torch.float64, device=device) - (lh - 1) / 2) / fs
    phase = math.pi * rate * t * t
    return torch.complex(torch.cos(phase), torch.sin(phase)).to(torch.complex64)


def scenes(config: dict, count: int, gen: torch.Generator) -> tuple:
    """(I, Q) float32 planes (count, n_az, n_rg) and the replica."""
    dev = gen.device
    n_az, n_rg, lh = config["n_az"], config["n_rg"], config["chirp_len"]
    pulse = replica(config, dev)
    raw = torch.randn((2, count, n_az, n_rg), generator=gen, device=dev).mul_(config["noise"])
    amp = torch.rand((count, len(config["targets"])), generator=gen, device=dev) + 0.5
    a = torch.arange(n_az, dtype=torch.float64, device=dev)
    for i, (fa, rg0) in enumerate(config["targets"]):
        rg = rg0 * n_rg // config["targets_at_n_rg"]
        width = min(lh, n_rg - rg)
        ang = 2 * math.pi * fa * a
        tone = torch.complex(torch.cos(ang), torch.sin(ang)).to(torch.complex64)
        echo = amp[:, i, None, None] * (tone[:, None] * pulse[None, :width])[None]
        raw[0, :, :, rg:rg + width] += echo.real
        raw[1, :, :, rg:rg + width] += echo.imag
    return raw[0], raw[1], pulse


class Pipeline:
    def __init__(self, config: dict, traffic: dict, device: torch.device, seed: int, faults: tuple = ()):
        from repro_torch.core import fft
        from repro_torch.core.fft_torch import cmul

        self.inputs = config["scenes"]
        self.faults = faults
        self.traced = False
        gen = torch.Generator(device=device).manual_seed(seed)
        self.raw_i, self.raw_q, self.pulse = scenes(config, self.inputs, gen)
        n_az, n_rg = config["n_az"], config["n_rg"]
        self.n_rg = n_rg
        self.n = ref.next_pow2(n_rg + config["chirp_len"] - 1)
        self.images = torch.zeros((self.inputs, n_az, n_rg), device=device)
        self.cmul = cmul
        self.fwd = fft.plan(fft.FFTSpec(n=self.n, kind="fft"), device=device)
        self.inv = fft.plan(fft.FFTSpec(n=self.n, kind="ifft"), device=device)
        self.azimuth = fft.plan(fft.FFTSpec(n=n_az, kind="fft", axis=-2), device=device)
        pr, pi_ = self.fwd.apply_planes(*self.pad(self.pulse.real.contiguous(), self.pulse.imag.contiguous()))
        self.matched = (pr, -pi_)  # the replica's conjugate spectrum
        #: Work of one request: its input samples.
        self.work = n_az * n_rg

    def pad(self, re: torch.Tensor, im: torch.Tensor) -> tuple:
        width = self.n - re.shape[-1]
        return tF.pad(re, (0, width)), tF.pad(im, (0, width))

    def warm(self) -> None:
        """Every plan and kernel this traffic uses, built and run once."""
        self.run(0)

    def run(self, k: int) -> None:
        if "skip_half" in self.faults and k % 2:
            return
        with spans.span("range_compression", self.traced):
            xr, xi = self.fwd.apply_planes(*self.pad(self.raw_i[k], self.raw_q[k]))
            yr, yi = self.inv.apply_planes(*self.cmul(xr, xi, *self.matched))
        with spans.span("azimuth", self.traced):
            ar, ai = self.azimuth.apply_planes(yr[:, :self.n_rg], yi[:, :self.n_rg])
        with spans.span("magnitude", self.traced):
            torch.hypot(ar, ai, out=self.images[k])
        if "alter_answer" in self.faults and k == 0:
            self.images[k].view(-1)[0] += 0.01 * self.images[k].abs().max()

    def release(self) -> None:
        """The program's working state: the plan handles and the spectrum
        they made (the images and blocks are the benchmark's)."""
        self.fwd = self.inv = self.azimuth = self.matched = self.cmul = None

    def output(self, k: int) -> torch.Tensor:
        return self.images[k]

    def reference(self, k: int, precision: str = "float64") -> torch.Tensor:
        return ref.stripmap_image(torch.complex(self.raw_i[k], self.raw_q[k]), self.pulse, precision)
