"""Direct DFT leaf (N ≤ 1024): ``Y = X·W`` with an optional per-bin phasor.

CUDA kernel ``csrc/dft_matmul.cu``, replacing the TPU kernel
``dft_matmul_call`` (``src/repro/kernels/dft_matmul.py:67``).  On the H100
the leaf is bound by fp32 arithmetic (6·B·N² flops over 16·B·N bytes); the
kernel is a tiled complex SGEMM on the CUDA cores whose 8 MB DFT matrix
(N = 1024) streams through shared memory in K-stripes from L2 — it cannot
sit in a block's 227 KB as it sat in VMEM.

:func:`dft_matmul_plain` is the same function in plain PyTorch, written as
the reference writes it (the 3-GEMM Karatsuba product of :func:`dft_tile`).
:func:`dft_matmul_call` takes it for a CPU tensor; for a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from repro_torch.core.fft_torch import cmul
from repro_torch.core.faults import PlanError
from repro_torch.kernels import build

__all__ = ["COUNTS", "dft_tile", "dft_matmul_plain", "dft_matmul_call"]

#: Kernel launches and plain-version calls, counted where each happens.
COUNTS = {"dft_matmul": 0, "dft_matmul_plain": 0}

_ARGS = (build.I64, build.I64) + (build.PTR,) * 9


def dft_tile(xr, xi, wr, wi):
    """Y = X @ W on split planes — Karatsuba, 3 real GEMMs."""
    k1 = torch.matmul(xr + xi, wr)
    k2 = torch.matmul(xr, wi - wr)
    k3 = torch.matmul(xi, wr + wi)
    return k1 - k3, k1 + k2


def dft_matmul_plain(xr, xi, wr, wi, *, twiddle=None):
    """Plain PyTorch version of the kernel (any device)."""
    COUNTS["dft_matmul_plain"] += 1
    yr, yi = dft_tile(xr, xi, wr, wi)
    if twiddle is not None:
        yr, yi = cmul(yr, yi, twiddle[0], twiddle[1])
    return yr, yi


def dft_matmul_call(xr, xi, wr, wi, *, twiddle=None):
    """y = x @ W for split-complex x:(B, N), W:(N, N), float32.

    ``twiddle`` — optional (real, imag) per-bin phasors of shape (N,),
    multiplied into the result in the epilogue.
    """
    b, n = xr.shape
    er, ei = twiddle if twiddle is not None else (None, None)
    build.check_planes(
        "dft_matmul", xr,
        xr=(xr, (b, n)), xi=(xi, (b, n)), wr=(wr, (n, n)), wi=(wi, (n, n)),
        er=(er, (n,)), ei=(ei, (n,)),
    )
    if xr.device.type == "cpu":
        return dft_matmul_plain(xr, xi, wr, wi, twiddle=twiddle)
    if xr.device.type != "cuda":
        raise PlanError(f"dft_matmul runs on cuda or cpu tensors, got {xr.device}")
    return _launch(xr, xi, wr, wi, er, ei)


@build.on_device
def _launch(xr, xi, wr, wi, er, ei):
    b, n = xr.shape
    yr = torch.empty_like(xr)
    yi = torch.empty_like(xi)
    p = build.ptr
    rc = build.function("repro_dft_matmul", _ARGS)(
        b, n, p(xr), p(xi), p(wr), p(wi), p(er), p(ei), p(yr), p(yi),
        build.stream_ptr(xr),
    )
    build.check(rc, "dft_matmul")
    COUNTS["dft_matmul"] += 1
    return yr, yi
