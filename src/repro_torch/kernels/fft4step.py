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

:func:`cgemm_tile`, :func:`four_step_tile`, :func:`chunk_log2`,
:func:`scratch_planes` and ``TILE_N`` serve the pencil and Bluestein
kernels, whose four-step tiles stay DFT-matrix GEMMs (``csrc/tile.cuh``).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import limits
from repro_torch.core.fft_torch import cmul, stockham_fft
from repro_torch.core.faults import PlanError
from repro_torch.kernels import build
from repro_torch.kernels.dft_matmul import check_length

__all__ = [
    "COUNTS",
    "cgemm_tile",
    "four_step_tile",
    "fft4step_plain",
    "fft4step_call",
    "chunk_log2",
    "scratch_planes",
    "slab_needed",
]

#: Kernel launches and plain-version calls, counted where each happens.
COUNTS = {"fft4step": 0, "fft4step_plain": 0}

#: Output-tile width of the CUDA GEMM tiles (``BN`` in ``csrc/tile.cuh``).
TILE_N = 64

#: The longest signal the kernel takes, and the shortest factor of its
#: four-step split (n1, n2 ≥ 32).
MAX_N = 65536
MIN_FACTOR = 32

_ARGS = (build.I64,) * 5 + (build.PTR,) * 11


def cgemm_tile(ar, ai, br, bi):
    """Karatsuba complex GEMM on split planes: 3 real GEMMs."""
    k1 = torch.matmul(ar + ai, br)
    k2 = torch.matmul(ar, bi - br)
    k3 = torch.matmul(ai, br + bi)
    return k1 - k3, k1 + k2


def four_step_tile(xr, xi, w1r, w1i, tr, ti, w2r, w2i, n1: int, n2: int, natural_order: bool = True):
    """The four-step dataflow on a (bt, n1·n2) batch of signals.

    Returns (yr, yi) of shape (bt, n1·n2), in natural or pencil (k1-major)
    order — the reference's ``four_step_tile`` in torch.
    """
    bt = xr.shape[0]
    n = n1 * n2
    # (bt, n) → (n1, bt·n2): put the contracted factor on rows.
    xr = xr.reshape(bt, n1, n2).transpose(0, 1).reshape(n1, bt * n2)
    xi = xi.reshape(bt, n1, n2).transpose(0, 1).reshape(n1, bt * n2)
    ar, ai = cgemm_tile(w1r, w1i, xr, xi)  # column DFTs
    ar = ar.reshape(n1, bt, n2)
    ai = ai.reshape(n1, bt, n2)
    br, bi = cmul(ar, ai, tr[:, None, :], ti[:, None, :])  # twiddle
    cr, ci = cgemm_tile(br.reshape(n1 * bt, n2), bi.reshape(n1 * bt, n2), w2r, w2i)
    cr = cr.reshape(n1, bt, n2)
    ci = ci.reshape(n1, bt, n2)
    if natural_order:
        # Y[b, k2·n1 + k1] = C[k1, b, k2]
        return cr.permute(1, 2, 0).reshape(bt, n), ci.permute(1, 2, 0).reshape(bt, n)
    return cr.transpose(0, 1).reshape(bt, n), ci.transpose(0, 1).reshape(bt, n)


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
    if xr.device.type == "cpu":
        return fft4step_plain(xr, xi, rr, ri, twiddle_after=twiddle_after, **kw)
    if xr.device.type != "cuda":
        raise PlanError(f"fft4step runs on cuda or cpu tensors, got {xr.device}")
    return _launch(xr, xi, rr, ri, er, ei, n1, inverse, natural_order)


def chunk_log2(count: int, want: int) -> int:
    """log2 of the signals per block: ``want`` (a power of two) cut to the
    largest power of two dividing ``count``."""
    c = min(want, count & -count)
    return c.bit_length() - 1


def scratch_planes(like, n: int, lgc: int, signals: int | None = None):
    """A global scratch slab for the four-step intermediate, or (None, None)
    when a chunk of 2^lgc length-n signals keeps it in shared memory of
    ``like``'s card.

    The slab holds ``signals`` length-n signals (default: as many as
    ``like`` has — a launch whose last chunk is ragged covers more), so
    while the call runs it holds half again the device memory of its planes
    in and out.
    """
    fn = build.function("repro_four_step_smem_bytes", (build.I64, build.I64), build.I64)
    if fn(n, lgc) <= limits.memory_budget(like.device):
        return None, None
    numel = like.numel() if signals is None else signals * n
    return (
        torch.empty(numel, dtype=like.dtype, device=like.device),
        torch.empty(numel, dtype=like.dtype, device=like.device),
    )


def slab_needed(like, n: int) -> bool:
    """Whether a length-n signal takes the scratch slab on ``like``'s card:
    the radix kernel's shared memory for the whole signal
    (``repro_fft4step_smem_bytes``) is past the block's budget."""
    fn = build.function("repro_fft4step_smem_bytes", (build.I64,), build.I64)
    return fn(n) > limits.memory_budget(like.device)


@build.on_device
def _launch(xr, xi, rr, ri, er, ei, n1, inverse, natural_order):
    b, n = xr.shape
    sr = si = None
    if slab_needed(xr, n):
        sr = torch.empty_like(xr)
        si = torch.empty_like(xi)
    yr = torch.empty_like(xr)
    yi = torch.empty_like(xi)
    p = build.ptr
    rc = build.function("repro_fft4step", _ARGS)(
        b, n, n1, int(natural_order), int(inverse),
        p(xr), p(xi), p(rr), p(ri), p(er), p(ei), p(yr), p(yi), p(sr), p(si),
        build.stream_ptr(xr),
    )
    build.check(rc, "fft4step")
    COUNTS["fft4step"] += 1
    return yr, yi
