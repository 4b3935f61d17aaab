"""Fused four-step leaf (2048 ≤ n ≤ 65536): one HBM round trip per signal.

CUDA kernel ``csrc/fft4step.cu``, replacing the TPU kernel ``fft4step_call``
(``src/repro/kernels/fft4step.py:114``): ``A = W1·X``, ``B = A ⊙ T``,
``C = B·W2`` per signal, written in natural or k1-major order, times an
optional per-position phasor.  On the H100 it is bound by fp32 arithmetic
(6·n·(n1+n2) flops over 16·n bytes).  One block transforms a chunk of
signals; the n1 × n2 intermediate lives in shared memory while it fits
(n ≤ 16384) and in a global scratch slab the wrapper allocates beyond —
the reference's planner is kept, ``FUSED_MAX`` is not lowered.

:func:`fft4step_plain` is the same function in plain PyTorch, written as the
reference writes it (:func:`four_step_tile`).  :func:`fft4step_call` takes
it for a CPU tensor; for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from repro_torch.core import limits
from repro_torch.core.fft_torch import cmul
from repro_torch.core.faults import PlanError
from repro_torch.kernels import build

__all__ = [
    "COUNTS",
    "cgemm_tile",
    "four_step_tile",
    "fft4step_plain",
    "fft4step_call",
    "chunk_log2",
    "scratch_planes",
]

#: Kernel launches and plain-version calls, counted where each happens.
COUNTS = {"fft4step": 0, "fft4step_plain": 0}

#: Output-tile width of the CUDA GEMM tiles (``BN`` in ``csrc/tile.cuh``).
TILE_N = 64

_ARGS = (build.I64,) * 5 + (build.PTR,) * 15


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


def fft4step_plain(xr, xi, w1r, w1i, twr, twi, w2r, w2i, *, natural_order=True, twiddle_after=None):
    """Plain PyTorch version of the kernel (any device)."""
    COUNTS["fft4step_plain"] += 1
    n1, n2 = w1r.shape[0], w2r.shape[0]
    yr, yi = four_step_tile(xr, xi, w1r, w1i, twr, twi, w2r, w2i, n1, n2, natural_order)
    if twiddle_after is not None:
        yr, yi = cmul(yr, yi, twiddle_after[0], twiddle_after[1])
    return yr, yi


def fft4step_call(xr, xi, w1r, w1i, twr, twi, w2r, w2i, *, natural_order=True, twiddle_after=None):
    """Fused four-step FFT of x (B, n1·n2) split-complex float32.

    ``twiddle_after`` — optional (real, imag) per-output-position phasors of
    shape (n,), multiplied into the result after the relayout.
    """
    b, n = xr.shape
    n1, n2 = w1r.shape[0], w2r.shape[0]
    if n != n1 * n2:
        raise PlanError(f"fft4step: n={n} is not n1·n2 = {n1}·{n2}")
    er, ei = twiddle_after if twiddle_after is not None else (None, None)
    build.check_planes(
        "fft4step", xr,
        xr=(xr, (b, n)), xi=(xi, (b, n)),
        w1r=(w1r, (n1, n1)), w1i=(w1i, (n1, n1)),
        twr=(twr, (n1, n2)), twi=(twi, (n1, n2)),
        w2r=(w2r, (n2, n2)), w2i=(w2i, (n2, n2)),
        er=(er, (n,)), ei=(ei, (n,)),
    )
    if xr.device.type == "cpu":
        return fft4step_plain(
            xr, xi, w1r, w1i, twr, twi, w2r, w2i,
            natural_order=natural_order, twiddle_after=twiddle_after,
        )
    if xr.device.type != "cuda":
        raise PlanError(f"fft4step runs on cuda or cpu tensors, got {xr.device}")
    return _launch(xr, xi, w1r, w1i, twr, twi, w2r, w2i, er, ei, natural_order)


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


@build.on_device
def _launch(xr, xi, w1r, w1i, twr, twi, w2r, w2i, er, ei, natural_order):
    b, n = xr.shape
    n1, n2 = w1r.shape[0], w2r.shape[0]
    # Short second factors (n2 < 64) batch signals so GEMM tiles fill.
    lgc = chunk_log2(b, max(1, TILE_N // n2))
    sr, si = scratch_planes(xr, n, lgc)
    yr = torch.empty_like(xr)
    yi = torch.empty_like(xi)
    p = build.ptr
    rc = build.function("repro_fft4step", _ARGS)(
        b, n1, n2, lgc, int(natural_order),
        p(xr), p(xi), p(w1r), p(w1i), p(twr), p(twi), p(w2r), p(w2i),
        p(er), p(ei), p(yr), p(yi), p(sr), p(si), build.stream_ptr(xr),
    )
    build.check(rc, "fft4step")
    COUNTS["fft4step"] += 1
    return yr, yi
