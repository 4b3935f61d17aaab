"""Twiddle-factor / DFT-matrix factory — the paper's "texture memory" stage.

Port of ``repro/core/twiddle.py``, numpy only.  Every table is computed once
on the host in float64, rounded to float32 split planes and cached per size;
``kernels/ops.py`` uploads each once per device and keeps it resident there,
where the kernels read it through L2 (the texture-cache analogue; the radix
kernels' :func:`roots` table through the read-only path).  The values are
bit-equal to the reference's tables (:func:`roots`, which the reference
does not have, to row 1 of its DFT matrix).

:func:`twiddle_window` is the one table built on the device instead: the
distributed pencil FFT's per-rank column window of the inter-factor grid
(the reference's ``traced_twiddle``), with :func:`mulfrac_pow2` keeping
its phase exact past 2³¹ points.  Its angles are bit for bit the
reference's; its planes come from the device's float32 ``cos``/``sin``,
within one ulp of the reference's (XLA's CPU polynomials round
differently from torch's).
"""

from __future__ import annotations

import concurrent.futures
import functools
import os

import numpy as np
import torch

__all__ = [
    "dft_matrix",
    "twiddle_grid",
    "pass_twiddle",
    "stage_twiddle",
    "roots",
    "rfft_recomb_twiddle",
    "bluestein_chirp",
    "bluestein_postchirp",
    "bluestein_spectrum",
    "mulfrac_pow2",
    "window_angles",
    "twiddle_window",
]


@functools.lru_cache(maxsize=256)
def _dft_matrix_np(n: int, inverse: bool) -> tuple[np.ndarray, np.ndarray]:
    """(n, n) DFT matrix W[j, k] = exp(∓2πi·j·k/n), float64 → float32 planes."""
    j = np.arange(n, dtype=np.float64)
    # Reduce j*k mod n in integer arithmetic first: keeps the argument of
    # sin/cos small so float64 → float32 rounding stays at the ulp level even
    # for n = 2**20 (j*k up to ~1e12 would lose precision otherwise).
    jk = np.outer(np.arange(n, dtype=np.int64), np.arange(n, dtype=np.int64)) % n
    ang = (2.0 * np.pi / n) * jk.astype(np.float64)
    sign = 1.0 if inverse else -1.0
    return (
        np.cos(ang).astype(np.float32),
        (sign * np.sin(ang)).astype(np.float32),
    )


def dft_matrix(n: int, inverse: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """Cached (n, n) DFT matrix as (real, imag) float32 planes."""
    if n <= 0 or n & (n - 1):
        raise ValueError(f"DFT matrix size must be a power of two, got {n}")
    return _dft_matrix_np(n, inverse)


#: Grid entries one worker computes at a time (float64 temporaries of
#: 8 MiB each, whatever the grid's size), and the most workers.
_GRID_BLOCK = 1 << 20
_GRID_WORKERS = 8


@functools.lru_cache(maxsize=4)
def _grid_cos_sin(n1: int, n2: int) -> tuple[np.ndarray, np.ndarray]:
    """float32(cos θ), float32(sin θ) of θ = 2π·((k1·m2) mod n)/n over the
    (n1, n2) grid, the float64 math of the reference's table, in blocks of
    rows on the host's cores (numpy's ufuncs release the GIL), so a grid of
    2²⁹–2³⁰ entries costs its two float32 planes and seconds, not tens of
    GiB of temporaries.  Both directions share it: the inverse's imaginary
    plane is sin, the forward's its negation (exact)."""
    n = n1 * n2
    c = np.empty((n1, n2), np.float32)
    s = np.empty((n1, n2), np.float32)
    m2 = np.arange(n2, dtype=np.int64)[None, :]
    rows = max(1, _GRID_BLOCK // n2)

    def block(lo: int) -> None:
        k1 = np.arange(lo, min(lo + rows, n1), dtype=np.int64)[:, None]
        ang = (2.0 * np.pi / n) * ((k1 * m2) % n).astype(np.float64)
        c[lo:lo + rows] = np.cos(ang)
        s[lo:lo + rows] = np.sin(ang)

    starts = range(0, n1, rows)
    if len(starts) == 1:
        block(0)
    else:
        workers = min(len(starts), _GRID_WORKERS, len(os.sched_getaffinity(0)))
        with concurrent.futures.ThreadPoolExecutor(workers) as pool:
            list(pool.map(block, starts))
    return c, s


@functools.lru_cache(maxsize=256)
def _twiddle_grid_np(
    n1: int, n2: int, inverse: bool
) -> tuple[np.ndarray, np.ndarray]:
    c, s = _grid_cos_sin(n1, n2)
    return c, (s if inverse else np.negative(s))


def twiddle_grid(
    n1: int, n2: int, inverse: bool = False
) -> tuple[np.ndarray, np.ndarray]:
    """Four-step inter-factor twiddle T[k1, m2] = exp(∓2πi·k1·m2/(n1·n2))."""
    return _twiddle_grid_np(n1, n2, inverse)


def pass_twiddle(
    n_bins: int, n_phases: int, inverse: bool = False
) -> tuple[np.ndarray, np.ndarray]:
    """Inter-factor twiddle grid for one pass of the linearized program.

    ``T[k, p] = exp(∓2πi·k·p / (n_bins·n_phases))`` — multiplied into bin
    ``k`` of pencil ``p`` in the column-pass kernel's epilogue.  Host-cached
    once per (bins, phases) pair, uploaded to the device once, and streamed
    by the kernel once per pass (the paper's texture table, §2.3.1).
    Identical values to :func:`twiddle_grid`.
    """
    return _twiddle_grid_np(n_bins, n_phases, inverse)


@functools.lru_cache(maxsize=512)
def stage_twiddle(l: int, inverse: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """Stockham stage twiddle w[j] = exp(∓πi·j/l), j ∈ [0, l) — radix-2."""
    ang = (np.pi / l) * np.arange(l, dtype=np.float64)
    sign = 1.0 if inverse else -1.0
    return (
        np.cos(ang).astype(np.float32),
        (sign * np.sin(ang)).astype(np.float32),
    )


@functools.lru_cache(maxsize=64)
def roots(n: int, inverse: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """The n n-th roots of unity ω^k = exp(∓2πi·k/n), k ∈ [0, n), in float64
    rounded to float32 planes (conjugated for the inverse).

    The one table of the radix kernels (``csrc/radix.cuh``): every Stockham
    stage twiddle of a length-L transform with L | n is ω^{k·n/L}, the
    four-step inner roots are ω^{n2} and ω^{n1}, and the inter-factor
    twiddle T[k1, j2] is ω^{(k1·j2) mod n}.  8n bytes, where the DFT
    matrices it replaces hold 8n² (direct) or 8(n1² + n1·n2 + n2²).
    """
    if n <= 0 or n & (n - 1):
        raise ValueError(f"roots table length must be a power of two, got {n}")
    ang = (2.0 * np.pi / n) * np.arange(n, dtype=np.float64)
    sign = 1.0 if inverse else -1.0
    return (
        np.cos(ang).astype(np.float32),
        (sign * np.sin(ang)).astype(np.float32),
    )


def mulfrac_pow2(k1: torch.Tensor, m2: torch.Tensor, n: int) -> torch.Tensor:
    """frac((k1·m2) / n) for power-of-two ``n``, exact for any ``n`` up to
    2⁶², as the reference computes it.

    Both operands split into 16-bit halves, so every partial product stays
    below 2³² (held in int64: torch has no unsigned 32-bit arithmetic).
    Because ``n`` is a power of two each partial's share of the phase
    reduces on its own: ``frac(p·2^s / n) = (p mod (n >> s)) / (n >> s)``
    when ``n > 2^s`` and 0 otherwise; the mod is skipped when ``n >> s``
    exceeds 2³².  The four float32 terms are summed in the reference's
    order, so the float32 result is the reference's.

    ``k1``/``m2``: non-negative integer tensors (values < 2³¹) that
    broadcast.  Returns float32 in [0, 4); only the value mod 1 matters to
    cos/sin.
    """
    if n <= 0 or n & (n - 1):
        raise ValueError(f"n must be a power of two, got {n}")
    k1 = k1.to(torch.int64)
    m2 = m2.to(torch.int64)
    a, b = k1 >> 16, k1 & 0xFFFF
    c, d = m2 >> 16, m2 & 0xFFFF

    def term(p, shift):
        if n <= (1 << shift):
            return torch.zeros((), dtype=torch.float32, device=p.device)
        mod = n >> shift
        if mod < (1 << 32):
            p = p % mod
        return p.to(torch.float32) * torch.tensor(np.float32(1.0 / mod), device=p.device)

    # k1·m2 = ac·2³² + (ad + bc)·2¹⁶ + bd, each partial < 2³².
    return term(a * c, 32) + term(a * d, 16) + term(b * c, 16) + term(b * d, 0)


def window_angles(n1: int, n2: int, *, col_start: int = 0, col_count: int | None = None,
                  device=None) -> torch.Tensor:
    """The (n1, col_count) float32 angles 2π·k1·m2/n of :func:`twiddle_window`
    (``n = n1·n2``, ``m2 = col_start + j``), built on ``device``: for
    n < 2³¹ ``float32(2π/n) · float32((k1·m2) mod n)``, beyond it
    ``float32(2π) · mulfrac_pow2(k1, m2, n)`` — the reference's float32
    values, bit for bit."""
    n = n1 * n2
    q = n2 if col_count is None else col_count
    k1 = torch.arange(n1, dtype=torch.int64, device=device)[:, None]
    m2 = (col_start + torch.arange(q, dtype=torch.int64, device=device))[None, :]
    if n < 2**31:
        red = ((k1 * m2) % n).to(torch.float32)
        return torch.tensor(np.float32(2.0 * np.pi / n), device=device) * red
    return torch.tensor(np.float32(2.0 * np.pi), device=device) * mulfrac_pow2(k1, m2, n)


def twiddle_window(n1: int, n2: int, inverse: bool = False, *, col_start: int = 0,
                   col_count: int | None = None, device=None) -> tuple:
    """On-device window of the four-step twiddle grid: (real, imag) float32
    planes ``T[k1, j] = exp(∓2πi·k1·m2/n)``, ``n = n1·n2``, for the columns
    ``m2 ∈ [col_start, col_start + col_count)`` (default: the whole grid).

    Only the window is built, on ``device``: a rank of the distributed
    pencil FFT passes its own column offset and never holds another rank's
    table.  The counterpart of the reference's ``traced_twiddle``; see
    :func:`window_angles` for the phase."""
    ang = window_angles(n1, n2, col_start=col_start, col_count=col_count, device=device)
    sign = 1.0 if inverse else -1.0
    return torch.cos(ang), sign * torch.sin(ang)


def _chirp_angles(n: int) -> np.ndarray:
    """Chirp phase π·j²/n reduced exactly: j² mod 2n in int64 keeps the
    sin/cos argument < 2π so float64 → float32 rounding stays at the ulp
    level for any n the planner accepts (the j² ≈ 1e12 raw argument would
    lose the phase entirely)."""
    j = np.arange(n, dtype=np.int64)
    return (np.pi / n) * ((j * j) % (2 * n)).astype(np.float64)


@functools.lru_cache(maxsize=128)
def bluestein_chirp(n: int, inverse: bool = False):
    """Bluestein pre-multiply chirp A[j] = exp(∓iπ·j²/n), length n.

    The modulation that turns the DFT's jk cross term into a convolution:
    jk = (j² + k² − (k−j)²)/2, so X[k] = A[k]·Σ_j (x[j]A[j])·B[k−j] with
    B the conjugate chirp (:func:`bluestein_spectrum` carries B's padded
    circular spectrum).  Float32 (real, imag) planes, host-cached like
    every other LUT.
    """
    ang = _chirp_angles(n)
    sign = 1.0 if inverse else -1.0
    return (
        np.cos(ang).astype(np.float32),
        (sign * np.sin(ang)).astype(np.float32),
    )


@functools.lru_cache(maxsize=128)
def bluestein_postchirp(n: int, inverse: bool = False):
    """Bluestein post-multiply chirp — same phasor as the pre-chirp, with
    the 1/n inverse-DFT normalization folded in for ``inverse=True`` (the
    same fold-into-the-last-LUT convention the pow2 engines use)."""
    ang = _chirp_angles(n)
    sign = 1.0 if inverse else -1.0
    scale = (1.0 / n) if inverse else 1.0
    return (
        (scale * np.cos(ang)).astype(np.float32),
        (scale * sign * np.sin(ang)).astype(np.float32),
    )


@functools.lru_cache(maxsize=128)
def bluestein_spectrum(n: int, pad: int, inverse: bool = False):
    """Length-``pad`` circular spectrum B̂ of the Bluestein kernel chirp.

    b[m] = exp(±iπ·m²/n) wrapped circularly (b_circ[pad−m] = b[m] for
    1 ≤ m < n) so linear indices k−j ∈ (−n, n) all resolve; the spectrum
    is computed ONCE on the host in float64 (np.fft) and interned per
    (n, pad, direction) — the chirp analogue of the texture-cached twiddle
    tables.  Requires pad ≥ 2n−1 (the conv support) and pow2 pad.
    """
    if pad < 2 * n - 1:
        raise ValueError(f"bluestein pad {pad} < 2n-1 = {2 * n - 1}")
    if pad & (pad - 1):
        raise ValueError(f"bluestein pad must be a power of two, got {pad}")
    ang = _chirp_angles(n)
    sign = -1.0 if inverse else 1.0  # conjugate of the pre-chirp
    b = np.cos(ang) + 1j * sign * np.sin(ang)
    b_circ = np.zeros(pad, dtype=np.complex128)
    b_circ[:n] = b
    b_circ[pad - n + 1 :] = b[1:][::-1]
    spec = np.fft.fft(b_circ)
    return (
        spec.real.astype(np.float32),
        spec.imag.astype(np.float32),
    )


@functools.lru_cache(maxsize=128)
def rfft_recomb_twiddle(n: int, inverse: bool = False):
    """Recombination twiddles for real-FFT even/odd packing.

    For rfft of a length-``n`` real signal computed via a length-``n/2``
    complex FFT: X[k] = E[k] + e^{∓2πik/n}·O[k].  Returns the unit phasor
    e^{∓2πik/n} for k ∈ [0, n/2] as float32 planes (length n//2 + 1).
    """
    k = np.arange(n // 2 + 1, dtype=np.float64)
    ang = (2.0 * np.pi / n) * k
    sign = 1.0 if inverse else -1.0
    return (
        np.cos(ang).astype(np.float32),
        (sign * np.sin(ang)).astype(np.float32),
    )
