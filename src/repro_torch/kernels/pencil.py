"""Pass kernels of the split regime (n > 65536) and of the 2-D programs.

``cols_pass_call`` — CUDA kernel in ``csrc/pencil.cu``, replacing the TPU
kernel ``cols_pass_call`` (``src/repro/kernels/pencil.py:102``): on an
(R, f, s) view, a length-f transform down the middle axis of every column,
times the inter-factor twiddle ``T[k, c]`` (an (f, s) LUT streamed once).
``tw_every`` is the width-broadcast mode of a strip-mined 2-D column
program: the twiddle is an (f, s / tw_every) grid whose column
``c // tw_every`` serves a run of ``tw_every`` image columns.  ``s`` may be
any width (an rfft2 half-spectrum is m + 1 columns): the four-step
kernel's ragged last chunk takes its columns one at a time, with no padded
copy.

``cols_natural_call`` — CUDA kernel in ``csrc/pencil.cu``, replacing
``cols_natural_call`` (``src/repro/kernels/pencil.py:234``): on a
(B, P, f, w) view, a length-f transform down axis 2, written as
(B, f, P, w) — the n2-axis digit transpose of a strip-mined column program
fused into the write.  It is the column kernel with the output view changed.

``rows_natural_call`` — CUDA kernel in ``csrc/pencil.cu``, replacing
``rows_natural_call`` (``src/repro/kernels/pencil.py:178``): on a (B, p, f)
view, a length-f transform of every row written transposed to (B, f, p),
so the program's output lands in natural order with no transpose pass.

These embed the direct (f ≤ 1024) or four-step tile, as the reference's
``_tile_transform`` does, and are bound by fp32 arithmetic on the H100.
Loads and stores run along the contiguous axis — s (w) for the columns, the
output's p for the transposed rows — with 8-signal chunks (one 32-byte
sector per plane) in the four-step form.  The kernels write a new output
rather than the reference's in-place update.

``rfft_recomb_call`` / ``irfft_recomb_call`` — CUDA kernels in
``csrc/recomb.cu``, replacing ``rfft_recomb_call`` / ``irfft_recomb_call``
(``src/repro/kernels/pencil.py:313`` / ``:324``, both through
``_recomb_call`` at ``:284``): the Hermitian even/odd recombination of the
real-FFT packing, (B, m) ↔ (B, m + 1), one thread per output element.
They are bound by bytes.

Each ``*_plain`` function is the same computation in plain PyTorch; each
``*_call`` takes it for a CPU tensor, and for a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

import torch

from repro_torch.core import fft_torch
from repro_torch.core.fft_torch import cmul
from repro_torch.core.faults import PlanError
from repro_torch.kernels import build
from repro_torch.kernels.dft_matmul import dft_tile
from repro_torch.kernels.fft4step import chunk_log2, four_step_tile, scratch_planes

__all__ = [
    "COUNTS",
    "cols_pass_plain",
    "cols_pass_call",
    "cols_natural_plain",
    "cols_natural_call",
    "rows_natural_plain",
    "rows_natural_call",
    "rfft_recomb_plain",
    "rfft_recomb_call",
    "irfft_recomb_plain",
    "irfft_recomb_call",
]

#: Kernel launches and plain-version calls, counted where each happens.
COUNTS = {
    "cols_pass": 0,
    "cols_pass_plain": 0,
    "rows_natural": 0,
    "rows_natural_plain": 0,
    "cols_natural": 0,
    "cols_natural_plain": 0,
    "rfft_recomb": 0,
    "rfft_recomb_plain": 0,
    "irfft_recomb": 0,
    "irfft_recomb_plain": 0,
}

#: Signals per four-step block in the pass kernels: 8 floats = one 32-byte
#: sector per plane along the contiguous axis.
CHUNK = 8

_P = build.PTR
_I = build.I64
_COLS_DIRECT = (_I,) * 4 + (_P,) * 9
_COLS_FUSED = (_I,) * 6 + (_P,) * 15
_NATURAL_DIRECT = (_I,) * 4 + (_P,) * 7
_NATURAL_FUSED = (_I,) * 6 + (_P,) * 13
_ROWS_DIRECT = (_I,) * 3 + (_P,) * 7
_ROWS_FUSED = (_I,) * 5 + (_P,) * 13
_RECOMB = (_I,) * 2 + (_P,) * 7


def column_chunk_log2(s: int, want: int = CHUNK) -> int:
    """log2 of the columns per four-step block: ``want`` (a power of two),
    cut to the power of two at or above ``s``.  A width that is no multiple
    of the chunk ends in a ragged chunk, whose block transforms its columns
    one at a time."""
    c = min(want, 1 << max(s - 1, 0).bit_length())
    return c.bit_length() - 1


def _fused_blocks(r: int, s: int, lgc: int) -> int:
    return r * -(-s >> lgc)


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


def _tw_every_log2(s: int, tw_every: int) -> int:
    if tw_every < 1 or tw_every & (tw_every - 1) or s % tw_every:
        raise PlanError(
            f"cols_pass: tw_every={tw_every} must be a power of two dividing the width {s}"
        )
    return tw_every.bit_length() - 1


def cols_pass_plain(xr, xi, luts, twiddle=None, *, kind: str, n1: int = 0, n2: int = 0,
                    tw_every: int = 1):
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
        twr, twi = twiddle
        if tw_every > 1:  # column c takes twiddle column c // tw_every
            twr = twr.repeat_interleave(tw_every, dim=1)
            twi = twi.repeat_interleave(tw_every, dim=1)
        yr, yi = cmul(yr, yi, twr, twi)  # bin k of column c ⊙ T[k, c]
    return yr.contiguous(), yi.contiguous()


def cols_pass_call(xr, xi, luts, twiddle=None, *, kind: str, n1: int = 0, n2: int = 0,
                   tw_every: int = 1):
    """Strided-column transform pass: x (R, f, s) → y (R, f, s) with
    ``y[r, :, c] = FFT_f(x[r, :, c]) ⊙ T[:, c // tw_every]``.  ``twiddle``
    is the (f, s / tw_every) inter-factor grid as split planes, or None."""
    r, f, s = xr.shape
    _tw_every_log2(s, tw_every)
    _check("cols_pass", kind, xr, xi, (r, f, s), luts, n1, n2, f, twiddle, (f, s // tw_every))
    if xr.device.type == "cpu":
        return cols_pass_plain(xr, xi, luts, twiddle, kind=kind, n1=n1, n2=n2, tw_every=tw_every)
    return _launch_cols(xr, xi, luts, twiddle, kind, n1, n2, tw_every)


@build.on_device
def _launch_cols(xr, xi, luts, twiddle, kind, n1, n2, tw_every=1):
    r, f, s = xr.shape
    lgw = _tw_every_log2(s, tw_every)
    yr = torch.empty_like(xr)
    yi = torch.empty_like(xi)
    tr, ti = twiddle if twiddle is not None else (None, None)
    p = build.ptr
    if kind == "direct":
        wr, wi = luts
        rc = build.function("repro_cols_pass_direct", _COLS_DIRECT)(
            r, f, s, lgw, p(wr), p(wi), p(xr), p(xi), p(tr), p(ti), p(yr), p(yi),
            build.stream_ptr(xr),
        )
    else:
        # A chunk must not straddle two twiddle columns.
        lgc = column_chunk_log2(s) if lgw == 0 else min(column_chunk_log2(s), lgw)
        sr, si = scratch_planes(xr, f, lgc, _fused_blocks(r, s, lgc) << lgc)
        rc = build.function("repro_cols_pass_fused", _COLS_FUSED)(
            r, n1, n2, s, lgc, lgw, *map(p, luts), p(xr), p(xi), p(tr), p(ti),
            p(yr), p(yi), p(sr), p(si), build.stream_ptr(xr),
        )
    build.check(rc, "cols_pass")
    COUNTS["cols_pass"] += 1
    return yr, yi


def cols_natural_plain(xr, xi, luts, *, kind: str, n1: int = 0, n2: int = 0):
    """Plain PyTorch version of the digit-transposing column pass (any
    device)."""
    COUNTS["cols_natural_plain"] += 1
    b, pp, f, w = xr.shape
    # (B, P, f, w) → (B·P·w, f): each column becomes a row of the tile.
    tr_ = xr.transpose(2, 3).reshape(b * pp * w, f)
    ti_ = xi.transpose(2, 3).reshape(b * pp * w, f)
    yr, yi = _tile_transform(tr_, ti_, luts, kind, n1, n2)
    yr = yr.reshape(b, pp, w, f).permute(0, 3, 1, 2)  # → (B, f, P, w)
    yi = yi.reshape(b, pp, w, f).permute(0, 3, 1, 2)
    return yr.contiguous(), yi.contiguous()


def cols_natural_call(xr, xi, luts, *, kind: str, n1: int = 0, n2: int = 0):
    """Final column pass of a strip-mined 2-D program with the n2-axis digit
    transpose fused into its write: x (B, P, f, w) → y (B, f, P, w),
    ``y[b, k, p, :] = FFT_f(x[b, p, :, :], axis=0)[k]``."""
    b, pp, f, w = xr.shape
    _check("cols_natural", kind, xr, xi, (b, pp, f, w), luts, n1, n2, f)
    if xr.device.type == "cpu":
        return cols_natural_plain(xr, xi, luts, kind=kind, n1=n1, n2=n2)
    return _launch_cols_natural(xr, xi, luts, kind, n1, n2)


@build.on_device
def _launch_cols_natural(xr, xi, luts, kind, n1, n2):
    b, pp, f, w = xr.shape
    yr = torch.empty((b, f, pp, w), dtype=xr.dtype, device=xr.device)
    yi = torch.empty((b, f, pp, w), dtype=xr.dtype, device=xr.device)
    p = build.ptr
    if kind == "direct":
        wr, wi = luts
        rc = build.function("repro_cols_natural_direct", _NATURAL_DIRECT)(
            b, pp, f, w, p(wr), p(wi), p(xr), p(xi), p(yr), p(yi), build.stream_ptr(xr),
        )
    else:
        lgc = column_chunk_log2(w)
        sr, si = scratch_planes(xr, f, lgc, _fused_blocks(b * pp, w, lgc) << lgc)
        rc = build.function("repro_cols_natural_fused", _NATURAL_FUSED)(
            b, pp, n1, n2, w, lgc, *map(p, luts), p(xr), p(xi), p(yr), p(yi),
            p(sr), p(si), build.stream_ptr(xr),
        )
    build.check(rc, "cols_natural")
    COUNTS["cols_natural"] += 1
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


@build.on_device
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


# ---------------------------------------------------------------------------
# Hermitian recombination of the real-FFT packing
# ---------------------------------------------------------------------------


def _check_recomb(name, xr, xi, wr, wi, m):
    b, width = xr.shape
    if m < 1:
        raise PlanError(f"{name}: the packed spectrum needs m >= 1 points, got {m}")
    build.check_planes(
        name, xr, xr=(xr, (b, width)), xi=(xi, (b, width)), wr=(wr, (m + 1,)), wi=(wi, (m + 1,)),
    )
    if xr.device.type not in ("cpu", "cuda"):
        raise PlanError(f"{name} runs on cuda or cpu tensors, got {xr.device}")


def rfft_recomb_plain(zr, zi, wr, wi):
    """Plain PyTorch version of the forward recombination (any device)."""
    COUNTS["rfft_recomb_plain"] += 1
    return fft_torch.rfft_recomb(zr, zi, wr, wi)


def rfft_recomb_call(zr, zi, wr, wi):
    """Forward recombination pass: packed spectrum Z (B, m) → the m + 1
    real-FFT bins (B, m + 1).  ``wr/wi``: the (m + 1,) e^{−2πik/n} LUT
    (``twiddle.rfft_recomb_twiddle(n)``)."""
    m = zr.shape[-1]
    _check_recomb("rfft_recomb", zr, zi, wr, wi, m)
    if zr.device.type == "cpu":
        return rfft_recomb_plain(zr, zi, wr, wi)
    return _launch_recomb(zr, zi, wr, wi, "rfft_recomb", m, m + 1)


def irfft_recomb_plain(xr, xi, wr, wi):
    """Plain PyTorch version of the inverse recombination (any device)."""
    COUNTS["irfft_recomb_plain"] += 1
    return fft_torch.irfft_recomb(xr, xi, wr, wi)


def irfft_recomb_call(xr, xi, wr, wi):
    """Inverse recombination pass: bins (B, m + 1) → packed spectrum Z
    (B, m).  ``wr/wi``: the (m + 1,) e^{+2πik/n} LUT
    (``twiddle.rfft_recomb_twiddle(n, inverse=True)``)."""
    m = xr.shape[-1] - 1
    _check_recomb("irfft_recomb", xr, xi, wr, wi, m)
    if xr.device.type == "cpu":
        return irfft_recomb_plain(xr, xi, wr, wi)
    return _launch_recomb(xr, xi, wr, wi, "irfft_recomb", m, m)


@build.on_device
def _launch_recomb(xr, xi, wr, wi, name, m, width):
    b = xr.shape[0]
    yr = torch.empty((b, width), dtype=xr.dtype, device=xr.device)
    yi = torch.empty((b, width), dtype=xr.dtype, device=xr.device)
    p = build.ptr
    rc = build.function(f"repro_{name}", _RECOMB)(
        b, m, p(xr), p(xi), p(wr), p(wi), p(yr), p(yi), build.stream_ptr(xr),
    )
    build.check(rc, name)
    COUNTS[name] += 1
    return yr, yi
