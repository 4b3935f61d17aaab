"""Numpy oracles for the FFT kernels (port of ``repro/kernels/ref.py``).

The reference module's ``jnp_fft`` helpers are not carried over: the port's
tests use ``np.fft`` as the library oracle.
"""

from __future__ import annotations

import numpy as np

__all__ = ["naive_dft", "four_step_ref", "np_fft"]


def naive_dft(x: np.ndarray, inverse: bool = False) -> np.ndarray:
    """O(N²) float64 DFT over the last axis — the ground-truth oracle."""
    x = np.asarray(x, dtype=np.complex128)
    n = x.shape[-1]
    k = np.arange(n)
    sign = 2j if inverse else -2j
    w = np.exp(sign * np.pi * np.outer(k, k) / n)
    y = x @ w
    if inverse:
        y = y / n
    return y


def four_step_ref(x: np.ndarray, n1: int, n2: int, inverse: bool = False) -> np.ndarray:
    """Numpy four-step reference mirroring the fused kernel's dataflow.

    x: (..., n1*n2) complex.  Returns the natural-order transform, computed
    via the same (W1·X ⊙ T)·W2 factorisation the kernel uses, in float64.
    """
    x = np.asarray(x, dtype=np.complex128)
    n = n1 * n2
    sign = 2j if inverse else -2j
    j1 = np.arange(n1)
    j2 = np.arange(n2)
    w1 = np.exp(sign * np.pi * np.outer(j1, j1) / n1)
    w2 = np.exp(sign * np.pi * np.outer(j2, j2) / n2)
    tw = np.exp(sign * np.pi * np.outer(j1, j2) / n)
    X = x.reshape(*x.shape[:-1], n1, n2)
    A = np.einsum("ij,...jk->...ik", w1, X)
    B = A * tw
    C = np.einsum("...ij,jk->...ik", B, w2)
    out = np.swapaxes(C, -1, -2).reshape(*x.shape[:-1], n)
    if inverse:
        out = out / n
    return out


def np_fft(spec, x: np.ndarray) -> np.ndarray:
    """``spec``'s transform of ``x`` (an ``FFTSpec`` of any kind, ``axis``
    -1 or -2) by the one ``np.fft`` call that computes it."""
    n, ax = spec.n, spec.axis
    return {
        "fft": lambda: np.fft.fft(x, axis=ax),
        "ifft": lambda: np.fft.ifft(x, axis=ax),
        "rfft": lambda: np.fft.rfft(x, axis=ax),
        "irfft": lambda: np.fft.irfft(x, n=n, axis=ax),
        "fft2": lambda: np.fft.fft2(x),
        "ifft2": lambda: np.fft.ifft2(x),
        "rfft2": lambda: np.fft.rfft2(x),
        "irfft2": lambda: np.fft.irfft2(x, s=(x.shape[-2], n)),
    }[spec.kind]()
