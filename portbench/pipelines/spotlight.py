"""Spotlight SAR image formation through the port, one scene a request.

After dechirp-on-receive a spotlight scene's image is the magnitude of the
2-D FFT of its phase history: one planned ``FFTSpec(n_rg, kind="fft2",
n2=n_az)`` over the complex64 history, its magnitude scaled by
1/(n_az·n_rg) into the scene's resident image buffer.  The plain transform
path of the port, with no convolution layer.

The histories are made on the device from the seed: per target (azimuth
bin, range bin: ``spotlight_targets``, scaled from ``spotlight_targets_at``
as the repo's SAR example scales them) a 2-D complex sinusoid (phase in float64), at an amplitude drawn per
scene from U(0.5, 1.5), plus complex Gaussian noise of standard deviation
``noise``.
"""

from __future__ import annotations

import math

import torch

from portbench import spans
from portbench.reference import sar as ref


def histories(config: dict, count: int, gen: torch.Generator) -> torch.Tensor:
    """(count, n_az, n_rg) complex64 dechirped phase histories."""
    dev = gen.device
    n_az, n_rg = config["n_az"], config["n_rg"]
    ref_az, ref_rg = config["spotlight_targets_at"]
    noise = torch.randn((2, count, n_az, n_rg), generator=gen, device=dev).mul_(config["noise"])
    ph = torch.complex(noise[0], noise[1])
    del noise
    amp = torch.rand((count, len(config["spotlight_targets"])), generator=gen, device=dev) + 0.5
    a = torch.arange(n_az, dtype=torch.float64, device=dev)[:, None] / n_az
    r = torch.arange(n_rg, dtype=torch.float64, device=dev)[None, :] / n_rg
    for i, (az0, rg0) in enumerate(config["spotlight_targets"]):
        ang = 2 * math.pi * ((az0 * n_az // ref_az) * a + (rg0 * n_rg // ref_rg) * r)
        tone = torch.complex(torch.cos(ang), torch.sin(ang)).to(torch.complex64)
        ph += amp[:, i, None, None] * tone[None]
    return ph


class Pipeline:
    def __init__(self, config: dict, traffic: dict, device: torch.device, seed: int, faults: tuple = ()):
        from repro_torch.core import fft

        self.inputs = config["scenes"]
        self.faults = faults
        self.traced = False
        n_az, n_rg = config["n_az"], config["n_rg"]
        gen = torch.Generator(device=device).manual_seed(seed)
        self.history = histories(config, self.inputs, gen)
        self.images = torch.zeros(self.history.shape, dtype=torch.float32, device=device)
        self.fft2 = fft.plan(fft.FFTSpec(n=n_rg, kind="fft2", n2=n_az), device=device)
        self.scale = 1.0 / (n_az * n_rg)
        self.work = n_az * n_rg

    def warm(self) -> None:
        self.run(0)

    def run(self, k: int) -> None:
        if "skip_half" in self.faults and k % 2:
            return
        with spans.span("fft2", self.traced):
            spec = self.fft2(self.history[k])
        with spans.span("magnitude", self.traced):
            torch.mul(spec.abs(), self.scale, out=self.images[k])
        if "alter_answer" in self.faults and k == 0:
            self.images[k].view(-1)[0] += 0.01 * self.images[k].abs().max()

    def release(self) -> None:
        self.fft2 = None

    def output(self, k: int) -> torch.Tensor:
        return self.images[k]

    def reference(self, k: int, precision: str = "float64") -> torch.Tensor:
        return ref.spotlight_image(self.history[k], precision)
