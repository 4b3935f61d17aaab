"""The pass-program executor: walks :attr:`FFTPlan.passes`, one kernel per pass.

Port of ``repro/kernels/ops.py``.  Every program pass is exactly one kernel
call (one HBM round trip):

* whole-signal pass  → :func:`~repro_torch.kernels.dft_matmul.dft_matmul_call`
  or :func:`~repro_torch.kernels.fft4step.fft4step_call`;
* strided-column pass → :func:`~repro_torch.kernels.pencil.cols_pass_call`,
  with the inter-factor twiddle in its epilogue;
* contiguous-row pass with the natural-order transpose fused into its write
  → :func:`~repro_torch.kernels.pencil.rows_natural_call`;
* column pass of a 2-D program (``axis=-2``, :func:`execute_program2d`) →
  :func:`~repro_torch.kernels.pencil.cols_pass_call` in place over the
  image's width (fused-regime columns, or the strided factor of strip-mined
  columns with its twiddle broadcast over the width), or
  :func:`~repro_torch.kernels.pencil.cols_natural_call` for the last factor
  of strip-mined columns, which writes the n2 axis in natural order.

Between passes there are views only (``Tensor.view``) — no transpose, copy
or twiddle multiply of its own.  The one exception is the reference's: a
multi-pass plan run down ``axis=-2`` of a 1-D spec goes through a transpose
sandwich.  On CUDA tensors each pass launches its kernel; on CPU tensors
each kernel wrapper takes its plain version, so a CPU run walks the same
program one plain call per pass.

LUTs are device-resident: the float64 host tables of ``core/twiddle.py``
are uploaded once per (device, sizes, direction) and kept, with the inverse
transform's 1/f folded into each pass's transform LUT exactly as the
reference folds it (W for the direct leaf, W2 for the four-step leaf), so
the factors of a program multiply to 1/n.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import faults
from repro_torch.core import plan as plan_lib
from repro_torch.core import twiddle as tw
from repro_torch.kernels import dft_matmul, fft4step, pencil

Planes = Tuple[torch.Tensor, torch.Tensor]

__all__ = [
    "device_key",
    "plan_luts",
    "recomb_luts",
    "pass_kernel",
    "plan_kernels",
    "execute_program",
    "execute_program2d",
    "execute_plan",
]


def device_key(device) -> str:
    """Canonical device string of a LUT cache key (``cuda`` → ``cuda:<i>``)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return f"cuda:{torch.cuda.current_device()}"
    return str(device)


def _upload(planes, device: str) -> tuple:
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in planes)


@functools.lru_cache(maxsize=64)
def _direct_luts(device: str, n: int, inverse: bool) -> tuple:
    wr, wi = tw.dft_matrix(n, inverse)
    if inverse:
        wr = wr / np.float32(n)  # fold 1/N into the LUT
        wi = wi / np.float32(n)
    return _upload((wr, wi), device)


@functools.lru_cache(maxsize=64)
def _fused_luts(device: str, n1: int, n2: int, inverse: bool) -> tuple:
    w1r, w1i = tw.dft_matrix(n1, inverse)
    tr, ti = tw.twiddle_grid(n1, n2, inverse)
    w2r, w2i = tw.dft_matrix(n2, inverse)
    if inverse:
        s = np.float32(1.0 / (n1 * n2))
        w2r, w2i = w2r * s, w2i * s
    return _upload((w1r, w1i, tr, ti, w2r, w2i), device)


@functools.lru_cache(maxsize=16)
def _pass_twiddle_luts(device: str, n_bins: int, n_phases: int, inverse: bool) -> tuple:
    """The (n_bins, n_phases) inter-factor grid of a column pass."""
    return _upload(tw.pass_twiddle(n_bins, n_phases, inverse), device)


@functools.lru_cache(maxsize=64)
def recomb_luts(device: str, n: int, inverse: bool) -> tuple:
    """The (n//2 + 1,) phasor LUT of the real-FFT recombination:
    e^{∓2πik/n}, conjugated for the inverse."""
    return _upload(tw.rfft_recomb_twiddle(n, inverse=inverse), device)


def _transform_luts(device: str, p: plan_lib.Pass, inverse: bool) -> tuple:
    if p.kind == "direct":
        return _direct_luts(device, p.n, inverse)
    return _fused_luts(device, p.n1, p.n2, inverse)


def _check_supported(p: plan_lib.Pass) -> None:
    if p.kind == "bluestein":
        raise NotImplementedError(
            "Bluestein (non-power-of-two) passes are not ported yet: ROADMAP A6"
        )
    if p.kind == "reorder":
        raise NotImplementedError(
            "the digit-reversal reorder pass (n > 2^32) is not ported yet: ROADMAP A3"
        )
    pencils, stride, _f = p.view_in
    if pencils > 1 and stride == 1 and p.view_out == p.view_in:
        raise NotImplementedError(
            "pencil-order row passes (order='pencil' programs) are not ported yet: ROADMAP A3"
        )


def pass_kernel(p: plan_lib.Pass) -> str:
    """Name of the kernel (and ``COUNTS`` key) that executes pass ``p``."""
    _check_supported(p)
    pencils, stride, _f = p.view_in
    if p.axis == -2:
        # Whole columns and strided column factors transform in place; the
        # last factor of strip-mined columns writes the n2 axis in order.
        return "cols_natural" if pencils > 1 and stride == 1 else "cols_pass"
    if pencils == 1:
        return "dft_matmul" if p.kind == "direct" else "fft4step"
    return "rows_natural" if stride == 1 else "cols_pass"


def plan_kernels(fft_plan: plan_lib.FFTPlan, axis: int = -1) -> tuple:
    """The kernel each pass of ``fft_plan`` launches, in order, when it runs
    over ``axis`` (-2: a 1-D plan down the second-to-last axis)."""
    if axis == -2 and fft_plan.n2 is None and len(fft_plan.passes) == 1:
        return ("cols_pass",)  # one in-place whole-column pass
    return tuple(pass_kernel(p) for p in fft_plan.passes)


def plan_luts(fft_plan: plan_lib.FFTPlan, inverse: bool, device) -> tuple:
    """Upload (or find) every LUT the plan's passes read on ``device``."""
    dev = device_key(device)
    luts = []
    for p in fft_plan.passes:
        _check_supported(p)
        luts.extend(_transform_luts(dev, p, inverse))
        if p.twiddle_after is not None:
            luts.extend(_pass_twiddle_luts(dev, *p.twiddle_after, inverse))
    return tuple(luts)


def _apply_pass(xr, xi, p: plan_lib.Pass, inverse: bool) -> Planes:
    """One row-axis program pass over (B, n) split planes: exactly one
    kernel call."""
    kernel = pass_kernel(p)
    faults.maybe_fail("kernel.launch", backend=xr.device.type, pass_kind=p.kind)
    dev = device_key(xr.device)
    b, n = xr.shape
    pencils, stride, f = p.view_in
    luts = _transform_luts(dev, p, inverse)
    if kernel == "dft_matmul":
        return dft_matmul.dft_matmul_call(xr, xi, *luts)
    if kernel == "fft4step":
        return fft4step.fft4step_call(xr, xi, *luts, natural_order=p.order == "natural")
    if kernel == "rows_natural":
        # (b, p, f) → (b, f, p) flattens to natural order.
        yr, yi = pencil.rows_natural_call(
            xr.view(b, pencils, f), xi.view(b, pencils, f), luts,
            kind=p.kind, n1=p.n1, n2=p.n2,
        )
        return yr.view(b, n), yi.view(b, n)
    groups = pencils // stride
    twiddle = None
    if p.twiddle_after is not None:
        twiddle = _pass_twiddle_luts(dev, *p.twiddle_after, inverse)
    yr, yi = pencil.cols_pass_call(
        xr.view(b * groups, f, stride), xi.view(b * groups, f, stride), luts, twiddle,
        kind=p.kind, n1=p.n1, n2=p.n2,
    )
    return yr.view(b, n), yi.view(b, n)


def _cols_image_pass(xr, xi, p: plan_lib.Pass, inverse: bool) -> Planes:
    """Column pass of a 2-D program: transform axis -2 of the (B, rows, w)
    image through the column kernels, over the whole width at once (any
    width: the kernel handles a ragged last chunk, so the reference's pad
    copy is not needed).

    Whole columns (``view_in == (1, 1, rows)``, or a 1-D plan's synthetic
    pass from :func:`_cols_plan_pass`) are one in-place column pass.
    Strip-mined columns arrive as the re-tagged 1-D program of the n2 axis:
    the strided factor runs in place on the (B, f, stride·w) view with its
    (f, stride) twiddle broadcast over runs of w columns, and the last
    factor writes (B, P, f, w) as (B, f, P, w), the n2 axis in natural
    order."""
    kernel = pass_kernel(p)
    faults.maybe_fail("kernel.launch", backend=xr.device.type, pass_kind=p.kind)
    dev = device_key(xr.device)
    b, rows, w = xr.shape
    pencils, stride, f = p.view_in
    luts = _transform_luts(dev, p, inverse)
    kw = dict(kind=p.kind, n1=p.n1, n2=p.n2)
    if pencils == 1 or f == rows:
        return pencil.cols_pass_call(xr, xi, luts, **kw)
    if kernel == "cols_pass":
        # Strided column factor (strip-mined columns have two factors):
        # n2-index t·stride + r, transform over t; the twiddle phase depends
        # on r only, shared by the w columns.
        twiddle = None
        if p.twiddle_after is not None:
            twiddle = _pass_twiddle_luts(dev, *p.twiddle_after, inverse)
        yr, yi = pencil.cols_pass_call(
            xr.view(b, f, stride * w), xi.view(b, f, stride * w), luts, twiddle,
            tw_every=w, **kw,
        )
    else:
        yr, yi = pencil.cols_natural_call(
            xr.view(b, pencils, f, w), xi.view(b, pencils, f, w), luts, **kw
        )
    return yr.view(b, rows, w), yi.view(b, rows, w)


def execute_program(xr, xi, passes: Sequence[plan_lib.Pass], *, inverse: bool = False) -> Planes:
    """Walk a linearized pass program over 2-D (B, n) split planes."""
    for p in passes:
        xr, xi = _apply_pass(xr, xi, p, inverse)
    return xr, xi


def execute_program2d(xr, xi, passes: Sequence[plan_lib.Pass], *, inverse: bool = False) -> Planes:
    """Walk a mixed-axis pass program over 3-D (B, n2, n) image planes.

    ``axis=-1`` passes run the 1-D machinery over the (B·n2, n) row view;
    ``axis=-2`` passes transform the image's columns in place through
    :func:`_cols_image_pass`.  The row → column handoff is a view: a planned
    ``fft2`` is exactly its rows' and columns' kernel calls."""
    for p in passes:
        b, rows, n = xr.shape
        if p.axis == -2:
            xr, xi = _cols_image_pass(xr, xi, p, inverse)
            continue
        yr, yi = _apply_pass(xr.view(b * rows, n), xi.view(b * rows, n), p, inverse)
        xr, xi = yr.view(b, rows, n), yi.view(b, rows, n)
    return xr, xi


def _cols_plan_pass(fft_plan: plan_lib.FFTPlan, stride: int) -> plan_lib.Pass:
    """A synthetic column pass running a whole one-pass plan down the -2 axis
    of an (..., n, stride) view, in place: no transpose."""
    leaf = fft_plan.passes[0]
    return plan_lib.Pass(
        kind=leaf.kind,
        n=fft_plan.n,
        n1=leaf.n1,
        n2=leaf.n2,
        view_in=(stride, stride, fft_plan.n),
        view_out=(stride, stride, fft_plan.n),
        order="natural",
        axis=-2,
    )


def _lead(shape) -> int:
    return int(np.prod(shape)) if shape else 1


def execute_plan(xr, xi, fft_plan: plan_lib.FFTPlan, *, inverse: bool = False, axis: int = -1) -> Planes:
    """Execute ``fft_plan`` over ``axis`` (-1 or -2) of split float32 planes
    with any leading batch dims.

    A multi-axis plan (``fft_plan.n2`` set) takes (..., n2, n) images and
    walks its joint program with :func:`execute_program2d`.  ``axis=-2``
    runs a one-pass plan as one in-place column pass and a longer plan
    through the reference's transpose sandwich."""
    # The planes go to the first pass as contiguous temporaries (no name
    # here keeps them alive past it).
    if xi.shape != xr.shape:
        raise faults.PlanError(f"real plane {tuple(xr.shape)} and imaginary {tuple(xi.shape)} differ")
    if fft_plan.n2 is not None:
        if axis != -1:
            raise faults.PlanError("multi-axis plans always transform the last two axes")
        rows, n = xr.shape[-2:]
        if (rows, n) != (fft_plan.n2, fft_plan.n):
            raise faults.PlanError(
                f"plan is for ({fft_plan.n2}, {fft_plan.n}) images, got ({rows}, {n})"
            )
        lead = xr.shape[:-2]
        b = _lead(lead)
        yr, yi = execute_program2d(
            xr.contiguous().view(b, rows, n), xi.contiguous().view(b, rows, n),
            fft_plan.passes, inverse=inverse,
        )
        return yr.view(*lead, rows, n), yi.view(*lead, rows, n)
    if axis == -2:
        n, q = xr.shape[-2:]
        if n != fft_plan.n:
            raise faults.PlanError(f"plan is for n={fft_plan.n}, axis -2 has n={n}")
        lead = xr.shape[:-2]
        if len(fft_plan.passes) == 1:
            b = _lead(lead)
            yr, yi = _cols_image_pass(
                xr.contiguous().view(b, n, q), xi.contiguous().view(b, n, q),
                _cols_plan_pass(fft_plan, q), inverse,
            )
            return yr.view(*lead, n, q), yi.view(*lead, n, q)
        yr, yi = execute_plan(xr.transpose(-1, -2), xi.transpose(-1, -2), fft_plan, inverse=inverse)
        return yr.transpose(-1, -2).contiguous(), yi.transpose(-1, -2).contiguous()
    if axis != -1:
        raise faults.PlanError(f"execute_plan handles axis -1 or -2, got {axis}")
    n = xr.shape[-1]
    if n != fft_plan.n:
        raise faults.PlanError(f"plan is for n={fft_plan.n}, input has n={n}")
    lead = xr.shape[:-1]
    b = _lead(lead)
    yr, yi = execute_program(
        xr.contiguous().view(b, n), xi.contiguous().view(b, n), fft_plan.passes, inverse=inverse
    )
    return yr.view(*lead, n), yi.view(*lead, n)
