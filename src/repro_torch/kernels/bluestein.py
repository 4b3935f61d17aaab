"""Bluestein chirp-convolution stages: FFTs of any length.

Bluestein's identity jk = (j² + k² − (k−j)²)/2 turns a length-n DFT of any
n into one circular convolution at a power-of-two pad M ≥ 2n − 1.  The
planner (``core/plan.compile_bluestein``) schedules it as two passes while
M ≤ 65536 (the fused regime) and as seven beyond (the split regime: three
elementwise stages around M's own two-pass forward and inverse programs).

``bluestein_fwd_call`` — CUDA kernel in ``csrc/bluestein.cu``, replacing
the TPU kernel ``bluestein_fwd_call`` (``src/repro/kernels/bluestein.py:85``):
x (B, n) → FFT_M(chirp·x ‖ 0) ⊙ B̂ (B, M).

``bluestein_inv_call`` — replacing ``bluestein_inv_call`` (``:142``):
x (B, M) → post·IFFT_M(x)[:, :n] (B, n), with 1/M in the inner LUTs and,
for an outer inverse, 1/n in ``post``.

``bluestein_elem_call`` — replacing ``bluestein_elem_call`` (``:197``): one
elementwise stage of the split regime, ``pre`` (B, n) → chirp·x padded to
(B, M), ``mul`` (B, M) ⊙ B̂, ``post`` (B, M) → post·x[:, :n] (B, n).

The fused stages run the leaves' GEMM tiles with the pre-chirp and the zero
pad folded into the loads and the bin mask into the store, so the pad is
never in memory and its rows cost no arithmetic; they are bound by fp32
arithmetic on the H100.  The elementwise stage is bound by bytes.  The
kernels write a new output where the reference's ``mul`` worked in place:
writing in place would not lower a split call's peak memory, since the pad
length's column and row passes around ``mul`` hold two (B, M) pairs too.

Each ``*_plain`` function is the same computation in plain PyTorch, from
:func:`~repro_torch.core.fft_torch.cmul` and the leaves' tile functions;
each ``*_call`` takes it for a CPU tensor, and for a CUDA tensor launches
the kernel or raises.  ``luts`` are the reference's, as 1-D planes:
``(chirp_r, chirp_i, *inner_fwd_luts, spec_r, spec_i)`` for ``fwd``,
``(*inner_inv_luts, post_r, post_i)`` for ``inv`` and the stage's pair for
``elem`` (``kernels/ops._bluestein_luts``).
"""

from __future__ import annotations

import torch

from repro_torch.core.fft_torch import cmul
from repro_torch.core.faults import PlanError
from repro_torch.kernels import build
from repro_torch.kernels.dft_matmul import dft_tile
from repro_torch.kernels.fft4step import TILE_N, chunk_log2, four_step_tile, scratch_planes

__all__ = [
    "COUNTS",
    "STAGES",
    "bluestein_fwd_plain",
    "bluestein_fwd_call",
    "bluestein_inv_plain",
    "bluestein_inv_call",
    "bluestein_elem_plain",
    "bluestein_elem_call",
]

#: Kernel launches and plain-version calls, counted where each happens.
COUNTS = {
    "bluestein_fwd": 0,
    "bluestein_fwd_plain": 0,
    "bluestein_inv": 0,
    "bluestein_inv_plain": 0,
    "bluestein_elem": 0,
    "bluestein_elem_plain": 0,
}

#: The elementwise stages of the split regime.
STAGES = ("pre", "mul", "post")

_P = build.PTR
_I = build.I64
_FWD_DIRECT = (_I,) * 3 + (_P,) * 11
_INV_DIRECT = (_I,) * 3 + (_P,) * 9
_FWD_FUSED = (_I,) * 5 + (_P,) * 17
_INV_FUSED = (_I,) * 5 + (_P,) * 15
_ELEM = (_I,) * 3 + (_P,) * 7


def _inner(xr, xi, inner_luts, inner_kind: str, in1: int, in2: int):
    """The pad-length transform of a (B, M) batch through the leaves' tiles."""
    if inner_kind == "direct":
        return dft_tile(xr, xi, *inner_luts)
    return four_step_tile(xr, xi, *inner_luts, in1, in2, True)


def _inner_shapes(inner_kind: str, m_pad: int, in1: int, in2: int):
    if inner_kind == "direct":
        return [(m_pad, m_pad)] * 2
    if inner_kind != "fused4" or in1 * in2 != m_pad:
        raise PlanError(f"bluestein: inner {inner_kind} {in1}·{in2} is no transform of M={m_pad}")
    return [(in1, in1)] * 2 + [(in1, in2)] * 2 + [(in2, in2)] * 2


def _check(name, xr, xi, width, luts, lut_shapes):
    if len(luts) != len(lut_shapes):
        raise PlanError(f"{name} takes {len(lut_shapes)} LUT planes, got {len(luts)}")
    b = xr.shape[0]
    ops = {"xr": (xr, (b, width)), "xi": (xi, (b, width))}
    ops.update({f"lut{i}": (t, s) for i, (t, s) in enumerate(zip(luts, lut_shapes))})
    build.check_planes(name, xr, **ops)
    if xr.device.type not in ("cpu", "cuda"):
        raise PlanError(f"{name} runs on cuda or cpu tensors, got {xr.device}")


def _check_pad(name, n: int, m_pad: int):
    if n < 2 or m_pad & (m_pad - 1) or m_pad < 2 * n - 1:
        raise PlanError(f"{name}: pad M={m_pad} must be a power of two ≥ 2n − 1 = {2 * n - 1}")


def bluestein_fwd_plain(xr, xi, luts, *, n: int, m_pad: int, inner_kind: str,
                        in1: int = 0, in2: int = 0):
    """Plain PyTorch version of the forward stage (any device)."""
    COUNTS["bluestein_fwd_plain"] += 1
    cr, ci, *inner, br, bi = luts
    yr, yi = cmul(xr, xi, cr, ci)
    yr = torch.nn.functional.pad(yr, (0, m_pad - n))
    yi = torch.nn.functional.pad(yi, (0, m_pad - n))
    fr, fi = _inner(yr, yi, inner, inner_kind, in1, in2)
    return cmul(fr, fi, br, bi)


def bluestein_fwd_call(xr, xi, luts, *, n: int, m_pad: int, inner_kind: str,
                       in1: int = 0, in2: int = 0):
    """Fused forward stage: x (B, n) → FFT_M(chirp·x ‖ 0) ⊙ B̂ (B, M).

    ``luts`` = (chirp_r, chirp_i, *inner_fwd_luts, spec_r, spec_i): the (n,)
    pre-chirp, the forward M-point transform's LUTs (direct W, or W1/T/W2
    of the ``in1 × in2`` four-step) and the (M,) chirp spectrum B̂."""
    _check_pad("bluestein_fwd", n, m_pad)
    shapes = [(n,)] * 2 + _inner_shapes(inner_kind, m_pad, in1, in2) + [(m_pad,)] * 2
    _check("bluestein_fwd", xr, xi, n, luts, shapes)
    if xr.device.type == "cpu":
        return bluestein_fwd_plain(xr, xi, luts, n=n, m_pad=m_pad, inner_kind=inner_kind,
                                   in1=in1, in2=in2)
    return _launch_fwd(xr, xi, luts, n, m_pad, inner_kind, in1, in2)


def _fused_chunk(b: int, in2: int) -> int:
    """log2 of the signals per four-step block, as ``fft4step`` picks it:
    short second factors batch signals so GEMM tiles fill."""
    return chunk_log2(b, max(1, TILE_N // in2))


@build.on_device
def _launch_fwd(xr, xi, luts, n, m_pad, inner_kind, in1, in2):
    b = xr.shape[0]
    yr = torch.empty((b, m_pad), dtype=xr.dtype, device=xr.device)
    yi = torch.empty((b, m_pad), dtype=xr.dtype, device=xr.device)
    p = build.ptr
    if inner_kind == "direct":
        rc = build.function("repro_bluestein_fwd_direct", _FWD_DIRECT)(
            b, n, m_pad, p(xr), p(xi), *map(p, luts), p(yr), p(yi), build.stream_ptr(xr),
        )
    else:
        lgc = _fused_chunk(b, in2)
        sr, si = scratch_planes(xr, m_pad, lgc, b)
        rc = build.function("repro_bluestein_fwd_fused", _FWD_FUSED)(
            b, n, in1, in2, lgc, p(xr), p(xi), *map(p, luts), p(yr), p(yi),
            p(sr), p(si), build.stream_ptr(xr),
        )
    build.check(rc, "bluestein_fwd")
    COUNTS["bluestein_fwd"] += 1
    return yr, yi


def bluestein_inv_plain(xr, xi, luts, *, n: int, m_pad: int, inner_kind: str,
                        in1: int = 0, in2: int = 0):
    """Plain PyTorch version of the inverse stage (any device)."""
    COUNTS["bluestein_inv_plain"] += 1
    *inner, pr, pi = luts
    gr, gi = _inner(xr, xi, inner, inner_kind, in1, in2)
    return cmul(gr[:, :n], gi[:, :n], pr, pi)


def bluestein_inv_call(xr, xi, luts, *, n: int, m_pad: int, inner_kind: str,
                       in1: int = 0, in2: int = 0):
    """Fused inverse stage: x (B, M) → post·IFFT_M(x)[:, :n] (B, n).

    ``luts`` = (*inner_inv_luts, post_r, post_i): the inverse M-point
    transform's LUTs (1/M folded in) and the (n,) post-chirp (1/n folded in
    for an outer inverse)."""
    _check_pad("bluestein_inv", n, m_pad)
    shapes = _inner_shapes(inner_kind, m_pad, in1, in2) + [(n,)] * 2
    _check("bluestein_inv", xr, xi, m_pad, luts, shapes)
    if xr.device.type == "cpu":
        return bluestein_inv_plain(xr, xi, luts, n=n, m_pad=m_pad, inner_kind=inner_kind,
                                   in1=in1, in2=in2)
    return _launch_inv(xr, xi, luts, n, m_pad, inner_kind, in1, in2)


@build.on_device
def _launch_inv(xr, xi, luts, n, m_pad, inner_kind, in1, in2):
    b = xr.shape[0]
    yr = torch.empty((b, n), dtype=xr.dtype, device=xr.device)
    yi = torch.empty((b, n), dtype=xr.dtype, device=xr.device)
    p = build.ptr
    if inner_kind == "direct":
        rc = build.function("repro_bluestein_inv_direct", _INV_DIRECT)(
            b, n, m_pad, p(xr), p(xi), *map(p, luts), p(yr), p(yi), build.stream_ptr(xr),
        )
    else:
        lgc = _fused_chunk(b, in2)
        sr, si = scratch_planes(xr, m_pad, lgc, b)
        rc = build.function("repro_bluestein_inv_fused", _INV_FUSED)(
            b, n, in1, in2, lgc, p(xr), p(xi), *map(p, luts), p(yr), p(yi),
            p(sr), p(si), build.stream_ptr(xr),
        )
    build.check(rc, "bluestein_inv")
    COUNTS["bluestein_inv"] += 1
    return yr, yi


def _elem_widths(stage: str, n: int, m_pad: int):
    """(input width, output width, LUT width) of an elementwise stage."""
    if stage == "pre":
        return n, m_pad, n
    if stage == "mul":
        return m_pad, m_pad, m_pad
    if stage == "post":
        return m_pad, n, n
    raise PlanError(f"bluestein_elem: stage must be one of {STAGES}, got {stage!r}")


def bluestein_elem_plain(xr, xi, planes, *, stage: str, n: int, m_pad: int):
    """Plain PyTorch version of an elementwise stage (any device)."""
    COUNTS["bluestein_elem_plain"] += 1
    if stage == "post":
        xr, xi = xr[:, :n], xi[:, :n]
    yr, yi = cmul(xr, xi, *planes)
    if stage == "pre":
        yr = torch.nn.functional.pad(yr, (0, m_pad - n))
        yi = torch.nn.functional.pad(yi, (0, m_pad - n))
    return yr, yi


def bluestein_elem_call(xr, xi, planes, *, stage: str, n: int, m_pad: int):
    """One elementwise chirp stage of the split regime: ``pre`` (B, n) →
    chirp·x zero-padded to (B, M); ``mul`` (B, M) → x ⊙ B̂; ``post``
    (B, M) → post·x[:, :n] (B, n).  ``planes``: the stage's LUT pair."""
    _check_pad("bluestein_elem", n, m_pad)
    w_in, w_out, w_lut = _elem_widths(stage, n, m_pad)
    _check("bluestein_elem", xr, xi, w_in, planes, [(w_lut,)] * 2)
    if xr.device.type == "cpu":
        return bluestein_elem_plain(xr, xi, planes, stage=stage, n=n, m_pad=m_pad)
    return _launch_elem(xr, xi, planes, w_in, w_out)


@build.on_device
def _launch_elem(xr, xi, planes, w_in, w_out):
    b = xr.shape[0]
    yr = torch.empty((b, w_out), dtype=xr.dtype, device=xr.device)
    yi = torch.empty((b, w_out), dtype=xr.dtype, device=xr.device)
    p = build.ptr
    rc = build.function("repro_bluestein_elem", _ELEM)(
        b, w_in, w_out, p(xr), p(xi), *map(p, planes), p(yr), p(yi), build.stream_ptr(xr),
    )
    build.check(rc, "bluestein_elem")
    COUNTS["bluestein_elem"] += 1
    return yr, yi
