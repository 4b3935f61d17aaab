"""Plain split-plane FFT math in torch — the port's counterpart of
``repro/core/fft_xla.py``.

Everything works on split real/imag float32 planes over the *last* axis, on
whatever device the tensors live on:

* :func:`cmul` — elementwise complex multiply;
* :func:`cmatmul` — the 3-GEMM Karatsuba complex product;
* :func:`direct_dft` — the whole-transform DFT matmul (N ≤ DIRECT_MAX);
* :func:`four_step_fft` — Bailey's four-step with the planner's
  factorisation policy, recursing through split levels;
* :func:`rfft_recomb` / :func:`irfft_recomb` — the Hermitian even/odd
  recombination of the real-FFT packing (flip and roll, no gather).

It shares no code with the kernels' plain versions (``kernels/*.py``) beyond
:func:`cmul` and the LUT tables, which makes it their independent oracle in
the tests.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core import plan as plan_lib
from repro_torch.core import twiddle as tw

Planes = Tuple[torch.Tensor, torch.Tensor]

__all__ = ["cmul", "cmatmul", "direct_dft", "four_step_fft", "rfft_recomb", "irfft_recomb"]


def cmul(ar, ai, br, bi) -> Planes:
    """Elementwise complex multiply on split planes."""
    return ar * br - ai * bi, ar * bi + ai * br


def rfft_recomb(zr, zi, wr, wi) -> Planes:
    """Hermitian recombination of the rfft even/odd packing (forward).

    X[k] = E[k] + w[k]·O[k] for k < m and X[m] = E[0] − O[0], with E and O
    taken from the packed m-point spectrum Z through the Z[(m − k) mod m]
    reversal (flip and roll).  ``wr/wi``: the e^{−2πik/n} phasors, length
    ≥ m.  Last axis, any leading dims.
    """
    zr_f = torch.roll(torch.flip(zr, (-1,)), 1, -1)  # Z[(m - k) % m]
    zi_f = torch.roll(torch.flip(zi, (-1,)), 1, -1)
    m = zr.shape[-1]
    er, ei = (zr + zr_f) * 0.5, (zi - zi_f) * 0.5
    or_, oi = (zi + zi_f) * 0.5, (zr_f - zr) * 0.5
    tr, ti = cmul(or_, oi, wr[..., :m], wi[..., :m])
    xr = torch.cat([er + tr, er[..., 0:1] - or_[..., 0:1]], dim=-1)
    xi = torch.cat([ei + ti, ei[..., 0:1] - oi[..., 0:1]], dim=-1)
    return xr, xi


def irfft_recomb(xr, xi, wr, wi) -> Planes:
    """Inverse of :func:`rfft_recomb`: m+1 bins → the packed m-point
    spectrum.  ``wr/wi``: the e^{+2πik/n} phasors, length ≥ m."""
    m = xr.shape[-1] - 1
    xr_k, xi_k = xr[..., :m], xi[..., :m]
    xr_f = torch.flip(xr[..., 1:], (-1,))  # X[m - k], k ∈ [0, m)
    xi_f = torch.flip(xi[..., 1:], (-1,))
    er, ei = (xr_k + xr_f) * 0.5, (xi_k - xi_f) * 0.5
    dr, di = (xr_k - xr_f) * 0.5, (xi_k + xi_f) * 0.5
    or_, oi = cmul(dr, di, wr[..., :m], wi[..., :m])
    return er - oi, ei + or_


def cmatmul(ar, ai, br, bi) -> Planes:
    """Complex matmul on split planes: (ar + i·ai) @ (br + i·bi).

    Karatsuba: k1 = (ar+ai)·br, k2 = ar·(bi−br), k3 = ai·(br+bi);
    re = k1 − k3, im = k1 + k2.
    """
    k1 = torch.matmul(ar + ai, br)
    k2 = torch.matmul(ar, bi - br)
    k3 = torch.matmul(ai, br + bi)
    return k1 - k3, k1 + k2


def _table(planes, like: torch.Tensor) -> Planes:
    re, im = planes
    return (
        torch.as_tensor(re, device=like.device),
        torch.as_tensor(im, device=like.device),
    )


def direct_dft(xr, xi, *, inverse: bool = False, _scale: bool = True) -> Planes:
    """Whole-transform DFT matmul (the N ≤ DIRECT_MAX leaf)."""
    n = xr.shape[-1]
    wr, wi = _table(tw.dft_matrix(n, inverse), xr)
    yr, yi = cmatmul(xr, xi, wr, wi)
    if inverse and _scale:
        yr, yi = yr / n, yi / n
    return yr, yi


def _col_dft(xr, xi, n1: int, inverse: bool) -> Planes:
    """Direct DFT over axis -2 as one contraction (no transpose)."""
    wr, wi = _table(tw.dft_matrix(n1, inverse), xr)
    k1 = torch.einsum("jk,...jm->...km", wr, xr + xi)
    k2 = torch.einsum("jk,...jm->...km", wi - wr, xr)
    k3 = torch.einsum("jk,...jm->...km", wr + wi, xi)
    return k1 - k3, k1 + k2


def _four_step_level(xr, xi, n1: int, n2: int, inverse: bool) -> Planes:
    """One split level: columns(n1) → twiddle → rows(n2) → transpose.

    x: (..., n1, n2) viewed row-major from a length n1·n2 signal; the
    output flattens to natural order (X[k1 + n1·k2] lives at [k2, k1]).
    """
    batch = xr.shape[:-2]
    tr, ti = _table(tw.twiddle_grid(n1, n2, inverse), xr)  # (n1, n2)
    if n1 <= plan_lib.DIRECT_MAX:
        xr, xi = _col_dft(xr, xi, n1, inverse)
        xr, xi = cmul(xr, xi, tr, ti)
    else:
        xr, xi = xr.transpose(-1, -2), xi.transpose(-1, -2)  # (..., n2, n1)
        xr, xi = _leaf_dispatch(xr, xi, n1, inverse)
        xr, xi = cmul(xr, xi, tr.T, ti.T)
        xr, xi = xr.transpose(-1, -2), xi.transpose(-1, -2)
    xr, xi = _leaf_dispatch(xr, xi, n2, inverse)
    xr, xi = xr.transpose(-1, -2), xi.transpose(-1, -2)  # (..., n2, n1)
    return xr.reshape(*batch, n1 * n2), xi.reshape(*batch, n1 * n2)


def _leaf_dispatch(xr, xi, n: int, inverse: bool) -> Planes:
    """Transform the last axis of length n (unscaled), recursing per plan."""
    if n == 1:
        return xr, xi
    if n <= plan_lib.DIRECT_MAX:
        return direct_dft(xr, xi, inverse=inverse, _scale=False)
    p = plan_lib.plan_fft(n)
    n1, n2 = p.levels[0] if p.levels else plan_lib.balanced_split(n)
    batch = xr.shape[:-1]
    xr = xr.reshape(*batch, n1, n2)
    xi = xi.reshape(*batch, n1, n2)
    return _four_step_level(xr, xi, n1, n2, inverse)


def four_step_fft(xr, xi, *, inverse: bool = False) -> Planes:
    """Four-step FFT over the last axis, following ``core.plan`` exactly."""
    n = xr.shape[-1]
    if n & (n - 1):
        raise ValueError(f"length must be a power of two, got {n}")
    yr, yi = _leaf_dispatch(xr, xi, n, inverse)
    if inverse:
        inv = np.float32(1.0 / n)
        yr, yi = yr * inv, yi * inv
    return yr, yi
