"""Whole-signal leaf (N ≤ 1024): ``y = DFT_N(x)`` with an optional per-bin
phasor, as a radix FFT in shared memory.

CUDA kernel ``csrc/dft_matmul.cu`` (engine ``csrc/radix.cuh``), replacing
the TPU kernel ``dft_matmul_call`` (``src/repro/kernels/dft_matmul.py:67``),
which multiplied by the whole N × N DFT matrix on the matrix unit.  On the
H100 the function is bound by bytes (about 5·N·log2 N flops over 16·N bytes
per signal), so the kernel does the FFT's work: each point is read from
device memory once and written once, the radix-2/4/8 butterflies run in
registers with their exchanges in shared memory, and the N roots of unity
(8·N bytes, not the 8·N² of the matrix) come through the read-only path.

:func:`dft_matmul_plain` is the same function in plain PyTorch: the radix-2
Stockham FFT (:func:`~repro_torch.core.fft_torch.stockham_fft`) over the
kernel's own roots table, then the scale and the phasor.
:func:`dft_matmul_call` takes it for a CPU tensor; for a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.fft_torch import cmul, stockham_fft
from repro_torch.core import fake
from repro_torch.core.faults import PlanError
from repro_torch.kernels import build
from repro_torch.runtime import tracing

__all__ = ["COUNTS", "MAX_N", "dft_matmul_plain", "dft_matmul_call"]

#: Kernel launches and plain-version calls, counted where each happens.
COUNTS = {"dft_matmul": 0, "dft_matmul_plain": 0}

#: The longest signal the wrapper passes to the kernel: the direct regime.
MAX_N = 1024

_ARGS = (build.I64,) * 3 + (build.PTR,) * 9


def dft_matmul_plain(xr, xi, rr, ri, *, inverse=False, twiddle=None):
    """Plain PyTorch version of the kernel (any device)."""
    COUNTS["dft_matmul_plain"] += 1
    yr, yi = stockham_fft(xr, xi, roots=(rr, ri))
    if inverse:
        s = np.float32(1.0 / xr.shape[-1])
        yr, yi = yr * s, yi * s
    if twiddle is not None:
        yr, yi = cmul(yr, yi, twiddle[0], twiddle[1])
    return yr, yi


def check_length(name: str, n: int, most: int) -> None:
    """Raise :class:`PlanError` unless ``n`` is a power of two up to ``most``."""
    if n < 1 or n & (n - 1) or n > most:
        raise PlanError(f"{name}: length {n} is not a power of two up to {most}")


def dft_matmul_call(xr, xi, rr, ri, *, inverse=False, twiddle=None):
    """The length-N DFT of split-complex x:(B, N) float32, N a power of two.

    ``rr``, ``ri`` — the (N,) roots table of the direction
    (:func:`repro_torch.core.twiddle.roots`); ``inverse`` scales by 1/N.
    ``twiddle`` — optional (real, imag) per-bin phasors of shape (N,),
    multiplied into the result at the store.
    """
    b, n = xr.shape
    check_length("dft_matmul", n, MAX_N)
    er, ei = twiddle if twiddle is not None else (None, None)
    build.check_planes(
        "dft_matmul", xr,
        xr=(xr, (b, n)), xi=(xi, (b, n)), rr=(rr, (n,)), ri=(ri, (n,)),
        er=(er, (n,)), ei=(ei, (n,)),
    )
    if xr.device.type == "cpu" and not fake.is_fake(xr):
        return dft_matmul_plain(xr, xi, rr, ri, inverse=inverse, twiddle=twiddle)
    if xr.device.type != "cuda" and not fake.is_fake(xr):
        raise PlanError(f"dft_matmul runs on cuda or cpu tensors, got {xr.device}")
    return _launch(xr, xi, rr, ri, er, ei, inverse)


@tracing.span("kernel.dft_matmul")
@build.on_device
def _launch(xr, xi, rr, ri, er, ei, inverse):
    b, n = xr.shape
    yr = torch.empty_like(xr)
    yi = torch.empty_like(xi)
    if xr.numel() == 0:  # an empty batch: nothing to launch
        return yr, yi
    if fake.launch("dft_matmul", (xr, xi, rr, ri, er, ei), (yr, yi), twiddle=er is not None):
        return yr, yi
    p = build.ptr
    rc = build.function("repro_dft_matmul", _ARGS)(
        b, n, int(inverse), p(xr), p(xi), p(rr), p(ri), p(er), p(ei), p(yr), p(yi),
        build.stream_ptr(xr),
    )
    build.check(rc, "dft_matmul")
    COUNTS["dft_matmul"] += 1
    return yr, yi
