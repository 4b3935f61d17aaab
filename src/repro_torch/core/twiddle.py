"""Twiddle-factor / DFT-matrix factory — the paper's "texture memory" stage.

Port of ``repro/core/twiddle.py``, numpy only.  Every table is computed once
on the host in float64, rounded to float32 split planes and cached per size;
``kernels/ops.py`` uploads each once per device and keeps it resident there,
where the kernels read it through L2 (the texture-cache analogue; the radix
kernels' :func:`roots` table through the read-only path).  The values are
bit-equal to the reference's tables (:func:`roots`, which the reference
does not have, to row 1 of its DFT matrix).

The reference's on-device generators (``traced_twiddle``, ``mulfrac_pow2``)
are not ported yet: no pass of the 1-D complex slice uses them.
"""

from __future__ import annotations

import functools

import numpy as np

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


@functools.lru_cache(maxsize=256)
def _twiddle_grid_np(
    n1: int, n2: int, inverse: bool
) -> tuple[np.ndarray, np.ndarray]:
    n = n1 * n2
    k1 = np.arange(n1, dtype=np.int64)[:, None]
    m2 = np.arange(n2, dtype=np.int64)[None, :]
    ang = (2.0 * np.pi / n) * ((k1 * m2) % n).astype(np.float64)
    sign = 1.0 if inverse else -1.0
    return (
        np.cos(ang).astype(np.float32),
        (sign * np.sin(ang)).astype(np.float32),
    )


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
