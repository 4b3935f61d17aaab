"""Plain split-plane FFT math in torch — the port's counterpart of
``repro/core/fft_xla.py``.

Everything works on split real/imag float32 planes over the *last* axis, on
whatever device the tensors live on:

* :func:`cmul` — elementwise complex multiply;
* :func:`cmatmul` — the 3-GEMM Karatsuba complex product;
* :func:`stockham_fft` — the radix-2 Stockham autosort FFT, the body of the
  radix kernels' plain versions (``kernels/dft_matmul.py``,
  ``kernels/fft4step.py``), its stage twiddles read from their roots table;
* :func:`direct_dft` — the whole-transform DFT matmul (N ≤ DIRECT_MAX);
* :func:`four_step_fft` — Bailey's four-step with the planner's
  factorisation policy, recursing through split levels;
* :func:`bluestein_fft` — any length through Bluestein's chirp
  convolution at a power-of-two pad;
* :func:`rfft_recomb` / :func:`irfft_recomb` — the Hermitian even/odd
  recombination of the real-FFT packing (flip and roll, no gather).

Apart from :func:`stockham_fft`, it shares no code with the kernels' plain
versions (``kernels/*.py``) beyond :func:`cmul` and the LUT tables, which
makes :func:`four_step_fft` and :func:`direct_dft` their independent oracle
in the tests.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core import plan as plan_lib
from repro_torch.core import twiddle as tw

Planes = Tuple[torch.Tensor, torch.Tensor]

__all__ = [
    "cmul", "cmatmul", "stockham_fft", "direct_dft", "four_step_fft", "bluestein_fft",
    "rfft_recomb", "irfft_recomb",
]


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


def stockham_fft(xr, xi, *, inverse: bool = False, roots=None) -> Planes:
    """Radix-2 Stockham autosort FFT over the last axis (split planes): the
    reference's ``fft_xla.stockham_fft``.

    ``roots`` — optional (real, imag) planes of the n n-th roots of the
    transform's direction (:func:`~repro_torch.core.twiddle.roots`, the
    radix kernels' table): stage l's twiddles ω_{2l}^j are its entries at
    stride n/(2l).  Without it each stage takes the reference's own table
    (:func:`~repro_torch.core.twiddle.stage_twiddle`).  ``inverse`` applies
    the 1/n scale (and picks the direction of the default tables).
    """
    n = xr.shape[-1]
    if n & (n - 1):
        raise ValueError(f"length must be a power of two, got {n}")
    if n == 1:
        return xr, xi
    batch = xr.shape[:-1]
    l, m = n // 2, 1
    while l >= 1:
        # View as (..., 2l, m): rows j and j+l form a butterfly pair.
        vr = xr.reshape(*batch, 2 * l, m)
        vi = xi.reshape(*batch, 2 * l, m)
        x0r, x1r = vr[..., :l, :], vr[..., l:, :]
        x0i, x1i = vi[..., :l, :], vi[..., l:, :]
        if roots is None:
            wr, wi = _table(tw.stage_twiddle(l, inverse), xr)
        else:
            step = n // (2 * l)
            wr, wi = roots[0][::step][:l], roots[1][::step][:l]
        wr, wi = wr[:, None], wi[:, None]
        s0r, s0i = x0r + x1r, x0i + x1i
        dr, di = x0r - x1r, x0i - x1i
        s1r, s1i = cmul(dr, di, wr, wi)
        # y[(2j+p)·m + k] ≡ (l, 2, m) row-major — Stockham auto-sorts.
        xr = torch.stack([s0r, s1r], dim=-2).reshape(*batch, n)
        xi = torch.stack([s0i, s1i], dim=-2).reshape(*batch, n)
        l //= 2
        m *= 2
    if inverse:
        inv = np.float32(1.0 / n)
        xr, xi = xr * inv, xi * inv
    return xr, xi


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


def bluestein_fft(xr, xi, *, inverse: bool = False, pad: int | None = None) -> Planes:
    """Any-length DFT over the last axis through Bluestein's chirp
    convolution (the reference's ``fft_xla.bluestein_fft``).

    Chirp pre-multiply, zero-pad to ``M = next_pow2(2n − 1)`` (or ``pad``),
    forward :func:`four_step_fft` at M, ⊙ the chirp spectrum B̂, inverse
    four-step at M (1/M applied there), slice to n, chirp post-multiply
    (1/n folded into it for ``inverse``).  The conv is forward then inverse
    whatever the outer direction, which only picks the chirp tables.  A
    power-of-two n goes straight to :func:`four_step_fft`.
    """
    n = xr.shape[-1]
    if not n & (n - 1):
        return four_step_fft(xr, xi, inverse=inverse)
    m_pad = plan_lib.bluestein_pad(n) if pad is None else pad
    ar, ai = _table(tw.bluestein_chirp(n, inverse), xr)
    br, bi = _table(tw.bluestein_spectrum(n, m_pad, inverse), xr)
    pr, pi = _table(tw.bluestein_postchirp(n, inverse), xr)
    yr, yi = cmul(xr, xi, ar, ai)
    yr = torch.nn.functional.pad(yr, (0, m_pad - n))
    yi = torch.nn.functional.pad(yi, (0, m_pad - n))
    fr, fi = four_step_fft(yr, yi)
    fr, fi = cmul(fr, fi, br, bi)
    gr, gi = four_step_fft(fr, fi, inverse=True)
    return cmul(gr[..., :n], gi[..., :n], pr, pi)
