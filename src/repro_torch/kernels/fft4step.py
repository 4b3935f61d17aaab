"""Whole-signal leaf (2048 ≤ n ≤ 65536): ``y = DFT_n(x)`` in natural or
k1-major order with an optional per-position phasor, as a radix FFT in
shared memory.

CUDA kernel ``csrc/fft4step.cu`` (engine ``csrc/radix.cuh``), replacing the
TPU kernel ``fft4step_call`` (``src/repro/kernels/fft4step.py:114``), which
ran the four-step ``A = W1·X``, ``B = A ⊙ T``, ``C = B·W2`` as two
DFT-matrix products.  On the H100 the function is bound by bytes (about
5·n·log2 n flops over 16·n bytes per signal), so the kernel does the FFT's
work and moves each point once each way while the signal fits a block's
shared memory (n ≤ 16384): butterflies in registers, exchanges in shared
memory, the n roots of unity through the read-only path.  At n = 32768 and
65536 it keeps the planner's four-step n1 × n2 with the intermediate in a
global scratch slab the wrapper allocates (two round trips per point).

:func:`fft4step_plain` is the same function in plain PyTorch: the radix-2
Stockham FFT over the kernel's own roots table, the scale, the k1-major
permutation and the phasor.  :func:`fft4step_call` takes it for a CPU
tensor; for a CUDA tensor it launches the kernel or raises.

:func:`slab_needed` and :data:`MIN_FACTOR` serve the Bluestein stages,
whose pad takes the tiles and the slab of this kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import fake, limits
from repro_torch.core.fft_torch import cmul, stockham_fft
from repro_torch.core.faults import PlanError
from repro_torch.kernels import build
from repro_torch.kernels.dft_matmul import check_length
from repro_torch.runtime import tracing

__all__ = [
    "COUNTS",
    "fft4step_plain",
    "fft4step_call",
    "slab_needed",
]

#: Kernel launches and plain-version calls, counted where each happens.
COUNTS = {"fft4step": 0, "fft4step_plain": 0}

#: The longest signal the kernel takes, and the shortest factor of its
#: four-step split (n1, n2 ≥ 32).
MAX_N = 65536
MIN_FACTOR = 32

_ARGS = (build.I64,) * 5 + (build.PTR,) * 11


def fft4step_plain(xr, xi, rr, ri, *, n1, inverse=False, natural_order=True, twiddle_after=None):
    """Plain PyTorch version of the kernel (any device)."""
    COUNTS["fft4step_plain"] += 1
    b, n = xr.shape
    yr, yi = stockham_fft(xr, xi, roots=(rr, ri))
    if inverse:
        s = np.float32(1.0 / n)
        yr, yi = yr * s, yi * s
    if not natural_order:
        # Position k1·n2 + k2 holds bin k2·n1 + k1.
        n2 = n // n1
        yr = yr.reshape(b, n2, n1).transpose(1, 2).reshape(b, n)
        yi = yi.reshape(b, n2, n1).transpose(1, 2).reshape(b, n)
    if twiddle_after is not None:
        yr, yi = cmul(yr, yi, twiddle_after[0], twiddle_after[1])
    return yr, yi


def fft4step_call(xr, xi, rr, ri, *, n1, inverse=False, natural_order=True, twiddle_after=None):
    """The length-n DFT of split-complex x:(B, n) float32, n = n1·n2 a power
    of two, in natural order or k1-major order (bin k2·n1 + k1 at position
    k1·n2 + k2).

    ``rr``, ``ri`` — the (n,) roots table of the direction
    (:func:`repro_torch.core.twiddle.roots`); ``inverse`` scales by 1/n;
    ``n1`` — the planner's first factor (the k1-major order, and the
    four-step split where the signal does not fit shared memory).
    ``twiddle_after`` — optional (real, imag) per-output-position phasors of
    shape (n,), multiplied into the result after the relayout.
    """
    b, n = xr.shape
    check_length("fft4step", n, MAX_N)
    if n1 < MIN_FACTOR or n1 & (n1 - 1) or n // n1 < MIN_FACTOR:
        raise PlanError(f"fft4step: n1={n1} is not a power-of-two factor of n={n} "
                        f"with n1, n/n1 >= {MIN_FACTOR}")
    er, ei = twiddle_after if twiddle_after is not None else (None, None)
    build.check_planes(
        "fft4step", xr,
        xr=(xr, (b, n)), xi=(xi, (b, n)), rr=(rr, (n,)), ri=(ri, (n,)),
        er=(er, (n,)), ei=(ei, (n,)),
    )
    kw = dict(n1=n1, inverse=inverse, natural_order=natural_order)
    if xr.device.type == "cpu" and not fake.is_fake(xr):
        return fft4step_plain(xr, xi, rr, ri, twiddle_after=twiddle_after, **kw)
    if xr.device.type != "cuda" and not fake.is_fake(xr):
        raise PlanError(f"fft4step runs on cuda or cpu tensors, got {xr.device}")
    return _launch(xr, xi, rr, ri, er, ei, n1, inverse, natural_order)


def slab_needed(like, n: int) -> bool:
    """Whether a length-n signal takes the scratch slab on ``like``'s card:
    the radix kernel's shared memory for the whole signal
    (:func:`smem_bytes`) is past the block's budget."""
    return smem_bytes(n) > limits.memory_budget(like.device)


def smem_bytes(n: int) -> int:
    """``repro_fft4step_smem_bytes`` (``radix_smem_bytes`` of radix.cuh):
    the exchange buffer of a tile of max(n, 4096) points, both planes,
    with one padding word per 32."""
    m = max(n, 4096)
    return 2 * (m + (m >> 5)) * 4


@tracing.span("kernel.fft4step")
@build.on_device
def _launch(xr, xi, rr, ri, er, ei, n1, inverse, natural_order):
    b, n = xr.shape
    yr = torch.empty_like(xr)
    yi = torch.empty_like(xi)
    if xr.numel() == 0:  # an empty batch: nothing to launch
        return yr, yi
    sr = si = None
    if slab_needed(xr, n):
        sr = torch.empty_like(xr)
        si = torch.empty_like(xi)
    if fake.launch("fft4step", (xr, xi, rr, ri, er, ei), (yr, yi), (sr, si), twiddle=er is not None):
        return yr, yi
    p = build.ptr
    rc = build.function("repro_fft4step", _ARGS)(
        b, n, n1, int(natural_order), int(inverse),
        p(xr), p(xi), p(rr), p(ri), p(er), p(ei), p(yr), p(yi), p(sr), p(si),
        build.stream_ptr(xr),
    )
    build.check(rc, "fft4step")
    COUNTS["fft4step"] += 1
    return yr, yi
