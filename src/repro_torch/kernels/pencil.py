"""Pass kernels of the split regime (n > 65536): every n ≤ 2³² in two passes.

``cols_pass_call`` — CUDA kernel in ``csrc/pencil.cu``, replacing the TPU
kernel ``cols_pass_call`` (``src/repro/kernels/pencil.py:102``): on an
(R, f, s) view, a length-f transform down the middle axis of every column,
times the inter-factor twiddle ``T[k, c]`` (an (f, s) LUT streamed once).

``rows_natural_call`` — CUDA kernel in ``csrc/pencil.cu``, replacing
``rows_natural_call`` (``src/repro/kernels/pencil.py:178``): on a (B, p, f)
view, a length-f transform of every row written transposed to (B, f, p),
so the program's output lands in natural order with no transpose pass.

Both embed the direct (f ≤ 1024) or four-step tile, as the reference's
``_tile_transform`` does, and are bound by fp32 arithmetic on the H100.
Loads and stores run along the contiguous axis — s for the columns, the
output's p for the transposed rows — with 8-signal chunks (one 32-byte
sector per plane) in the four-step form.  The kernels write a new output
rather than the reference's in-place update.

The reference's ``tw_every`` width-broadcast mode of the column pass serves
only 2-D programs and waits for that slice (ROADMAP A5).

Each ``*_plain`` function is the same computation in plain PyTorch; each
``*_call`` takes it for a CPU tensor, and for a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

import torch

from repro_torch.core.fft_torch import cmul
from repro_torch.core.faults import PlanError
from repro_torch.kernels import build
from repro_torch.kernels.dft_matmul import dft_tile
from repro_torch.kernels.fft4step import chunk_log2, four_step_tile, scratch_planes

__all__ = [
    "COUNTS",
    "cols_pass_plain",
    "cols_pass_call",
    "rows_natural_plain",
    "rows_natural_call",
]

#: Kernel launches and plain-version calls, counted where each happens.
COUNTS = {
    "cols_pass": 0,
    "cols_pass_plain": 0,
    "rows_natural": 0,
    "rows_natural_plain": 0,
}

#: Signals per four-step block in the pass kernels: 8 floats = one 32-byte
#: sector per plane along the contiguous axis.
CHUNK = 8

_P = build.PTR
_I = build.I64
_COLS_DIRECT = (_I,) * 3 + (_P,) * 9
_COLS_FUSED = (_I,) * 5 + (_P,) * 15
_ROWS_DIRECT = (_I,) * 3 + (_P,) * 7
_ROWS_FUSED = (_I,) * 5 + (_P,) * 13


def _tile_transform(xr, xi, luts, kind: str, n1: int, n2: int):
    """A (bt, f) batch of rows through the shared direct/four-step tiles."""
    if kind == "direct":
        wr, wi = luts
        return dft_tile(xr, xi, wr, wi)
    w1r, w1i, tr, ti, w2r, w2i = luts
    return four_step_tile(xr, xi, w1r, w1i, tr, ti, w2r, w2i, n1, n2, True)


def _lut_shapes(kind: str, f: int, n1: int, n2: int):
    if kind == "direct":
        return [(f, f)] * 2
    if n1 * n2 != f:
        raise PlanError(f"four-step factors {n1}·{n2} do not make f={f}")
    return [(n1, n1)] * 2 + [(n1, n2)] * 2 + [(n2, n2)] * 2


def _check(name, kind, xr, xi, x_shape, luts, n1, n2, f, twiddle=None, tw_shape=None):
    if kind not in ("direct", "fused4"):
        raise PlanError(f"{name}: kind must be 'direct' or 'fused4', got {kind!r}")
    shapes = _lut_shapes(kind, f, n1, n2)
    if len(luts) != len(shapes):
        raise PlanError(f"{name}: {kind} takes {len(shapes)} LUT planes, got {len(luts)}")
    ops = {"xr": (xr, x_shape), "xi": (xi, x_shape)}
    ops.update({f"lut{i}": (t, s) for i, (t, s) in enumerate(zip(luts, shapes))})
    if twiddle is not None:
        ops.update(tr=(twiddle[0], tw_shape), ti=(twiddle[1], tw_shape))
    build.check_planes(name, xr, **ops)
    if xr.device.type not in ("cpu", "cuda"):
        raise PlanError(f"{name} runs on cuda or cpu tensors, got {xr.device}")


def cols_pass_plain(xr, xi, luts, twiddle=None, *, kind: str, n1: int = 0, n2: int = 0):
    """Plain PyTorch version of the column pass (any device)."""
    COUNTS["cols_pass_plain"] += 1
    r, f, s = xr.shape
    # (R, f, s) → (R·s, f): each column becomes a row of the tile.
    tr_ = xr.transpose(1, 2).reshape(r * s, f)
    ti_ = xi.transpose(1, 2).reshape(r * s, f)
    yr, yi = _tile_transform(tr_, ti_, luts, kind, n1, n2)
    yr = yr.reshape(r, s, f).transpose(1, 2)
    yi = yi.reshape(r, s, f).transpose(1, 2)
    if twiddle is not None:
        yr, yi = cmul(yr, yi, twiddle[0], twiddle[1])  # bin k of column c ⊙ T[k, c]
    return yr.contiguous(), yi.contiguous()


def cols_pass_call(xr, xi, luts, twiddle=None, *, kind: str, n1: int = 0, n2: int = 0):
    """Strided-column transform pass: x (R, f, s) → y (R, f, s) with
    ``y[r, :, c] = FFT_f(x[r, :, c]) ⊙ T[:, c]``.  ``twiddle`` is the
    (f, s) inter-factor grid as split planes, or None."""
    r, f, s = xr.shape
    _check("cols_pass", kind, xr, xi, (r, f, s), luts, n1, n2, f, twiddle, (f, s))
    if xr.device.type == "cpu":
        return cols_pass_plain(xr, xi, luts, twiddle, kind=kind, n1=n1, n2=n2)
    return _launch_cols(xr, xi, luts, twiddle, kind, n1, n2)


def _launch_cols(xr, xi, luts, twiddle, kind, n1, n2):
    r, f, s = xr.shape
    yr = torch.empty_like(xr)
    yi = torch.empty_like(xi)
    tr, ti = twiddle if twiddle is not None else (None, None)
    p = build.ptr
    if kind == "direct":
        wr, wi = luts
        rc = build.function("repro_cols_pass_direct", _COLS_DIRECT)(
            r, f, s, p(wr), p(wi), p(xr), p(xi), p(tr), p(ti), p(yr), p(yi),
            build.stream_ptr(xr),
        )
    else:
        lgc = chunk_log2(s, CHUNK)
        sr, si = scratch_planes(xr, f, lgc)
        rc = build.function("repro_cols_pass_fused", _COLS_FUSED)(
            r, n1, n2, s, lgc, *map(p, luts), p(xr), p(xi), p(tr), p(ti),
            p(yr), p(yi), p(sr), p(si), build.stream_ptr(xr),
        )
    build.check(rc, "cols_pass")
    COUNTS["cols_pass"] += 1
    return yr, yi


def rows_natural_plain(xr, xi, luts, *, kind: str, n1: int = 0, n2: int = 0):
    """Plain PyTorch version of the transposed-write row pass (any device)."""
    COUNTS["rows_natural_plain"] += 1
    b, p, f = xr.shape
    yr, yi = _tile_transform(xr.reshape(b * p, f), xi.reshape(b * p, f), luts, kind, n1, n2)
    yr = yr.reshape(b, p, f).transpose(1, 2).contiguous()
    yi = yi.reshape(b, p, f).transpose(1, 2).contiguous()
    return yr, yi


def rows_natural_call(xr, xi, luts, *, kind: str, n1: int = 0, n2: int = 0):
    """Contiguous-row transform pass with the natural-order transpose fused
    into its write: x (B, p, f) → y (B, f, p), y[b, k, q] = FFT_f(x[b, q])[k]."""
    b, pp, f = xr.shape
    _check("rows_natural", kind, xr, xi, (b, pp, f), luts, n1, n2, f)
    if xr.device.type == "cpu":
        return rows_natural_plain(xr, xi, luts, kind=kind, n1=n1, n2=n2)
    return _launch_rows(xr, xi, luts, kind, n1, n2)


def _launch_rows(xr, xi, luts, kind, n1, n2):
    b, pp, f = xr.shape
    yr = torch.empty((b, f, pp), dtype=xr.dtype, device=xr.device)
    yi = torch.empty((b, f, pp), dtype=xr.dtype, device=xr.device)
    p = build.ptr
    if kind == "direct":
        wr, wi = luts
        rc = build.function("repro_rows_natural_direct", _ROWS_DIRECT)(
            b, pp, f, p(wr), p(wi), p(xr), p(xi), p(yr), p(yi), build.stream_ptr(xr),
        )
    else:
        lgc = chunk_log2(pp, CHUNK)
        sr, si = scratch_planes(xr, f, lgc)
        rc = build.function("repro_rows_natural_fused", _ROWS_FUSED)(
            b, pp, n1, n2, lgc, *map(p, luts), p(xr), p(xi), p(yr), p(yi),
            p(sr), p(si), build.stream_ptr(xr),
        )
    build.check(rc, "rows_natural")
    COUNTS["rows_natural"] += 1
    return yr, yi
