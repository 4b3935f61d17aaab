"""The pass-program executor: walks :attr:`FFTPlan.passes`, one kernel per pass.

Port of ``repro/kernels/ops.py`` for ``axis=-1``.  Every program pass is
exactly one kernel call (one HBM round trip):

* whole-signal pass  → :func:`~repro_torch.kernels.dft_matmul.dft_matmul_call`
  or :func:`~repro_torch.kernels.fft4step.fft4step_call`;
* strided-column pass → :func:`~repro_torch.kernels.pencil.cols_pass_call`,
  with the inter-factor twiddle in its epilogue;
* contiguous-row pass with the natural-order transpose fused into its write
  → :func:`~repro_torch.kernels.pencil.rows_natural_call`.

Between passes there are views only (``Tensor.view``) — no transpose, copy
or twiddle multiply of its own.  On CUDA tensors each pass launches its
kernel; on CPU tensors each kernel wrapper takes its plain version, so a CPU
run walks the same program one plain call per pass.

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
    "pass_kernel",
    "execute_program",
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
    if p.axis != -1:
        raise NotImplementedError("axis=-2 column passes are not ported yet: ROADMAP A5")
    pencils, stride, _f = p.view_in
    if pencils > 1 and stride == 1 and p.view_out == p.view_in:
        raise NotImplementedError(
            "pencil-order row passes (order='pencil' programs) are not ported yet: ROADMAP A3"
        )


def pass_kernel(p: plan_lib.Pass) -> str:
    """Name of the kernel (and ``COUNTS`` key) that executes pass ``p``."""
    _check_supported(p)
    pencils, stride, _f = p.view_in
    if pencils == 1:
        return "dft_matmul" if p.kind == "direct" else "fft4step"
    return "rows_natural" if stride == 1 else "cols_pass"


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
    """One program pass over (B, n) split planes: exactly one kernel call."""
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


def execute_program(xr, xi, passes: Sequence[plan_lib.Pass], *, inverse: bool = False) -> Planes:
    """Walk a linearized pass program over 2-D (B, n) split planes."""
    for p in passes:
        xr, xi = _apply_pass(xr, xi, p, inverse)
    return xr, xi


def execute_plan(xr, xi, fft_plan: plan_lib.FFTPlan, *, inverse: bool = False, axis: int = -1) -> Planes:
    """Execute ``fft_plan`` over the last axis of split float32 planes with
    any leading batch dims."""
    if axis != -1:
        raise NotImplementedError("axis=-2 transforms are not ported yet: ROADMAP A3")
    if fft_plan.n2 is not None:
        raise NotImplementedError("multi-axis (2-D) plans are not ported yet: ROADMAP A5")
    n = xr.shape[-1]
    if n != fft_plan.n:
        raise faults.PlanError(f"plan is for n={fft_plan.n}, input has n={n}")
    if xi.shape != xr.shape:
        raise faults.PlanError(f"real plane {tuple(xr.shape)} and imaginary {tuple(xi.shape)} differ")
    lead = xr.shape[:-1]
    b = int(np.prod(lead)) if lead else 1
    yr, yi = execute_program(
        xr.contiguous().view(b, n), xi.contiguous().view(b, n), fft_plan.passes, inverse=inverse
    )
    return yr.view(*lead, n), yi.view(*lead, n)
