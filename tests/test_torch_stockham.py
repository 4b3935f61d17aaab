"""The radix kernels' plain math against the reference.

``fft_torch.stockham_fft`` (the body of the ``dft_matmul`` and ``fft4step``
plain versions) against ``repro.core.fft_xla.stockham_fft`` on the same numpy
inputs, with the reference's stage tables and with the kernels' roots table;
the roots table against the reference's DFT matrix; and the two wrappers'
refusals.  Same algorithm in float32, so the tolerance is 1e-5·max|ref|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fft_xla
from repro.core import twiddle as ref_tw
from repro_torch.core import fft_torch
from repro_torch.core import twiddle as tw
from repro_torch.core.faults import PlanError
from repro_torch.kernels import dft_matmul, fft4step

TOL = 1e-5
LENGTHS = [1 << k for k in range(13)]  # 1 … 4096


def _planes(seed, shape):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal(shape).astype(np.float32),
        rng.standard_normal(shape).astype(np.float32),
    )


def _close(mine, ref):
    ref = [np.asarray(a) for a in ref]
    scale = max(np.abs(ref[0]).max(), np.abs(ref[1]).max())
    for a, b in zip(mine, ref):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=TOL * scale)


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("table", ["stage", "roots"])
def test_stockham_equals_the_reference(n, inverse, table):
    x = _planes(n, (3, n))
    roots = tuple(map(torch.from_numpy, tw.roots(n, inverse))) if table == "roots" else None
    mine = fft_torch.stockham_fft(*map(torch.from_numpy, x), inverse=inverse, roots=roots)
    ref = fft_xla.stockham_fft(*map(jnp.asarray, x), inverse=inverse)
    _close(mine, ref)


@pytest.mark.parametrize("n", [1, 2, 64, 4096])
@pytest.mark.parametrize("inverse", [False, True])
def test_roots_are_the_reference_dft_row(n, inverse):
    """ω^k is row 1 of the reference's DFT matrix (row 0 at n = 1), bit for
    bit."""
    wr, wi = ref_tw.dft_matrix(n, inverse)
    rr, ri = tw.roots(n, inverse)
    row = min(1, n - 1)
    np.testing.assert_array_equal(rr, wr[row])
    np.testing.assert_array_equal(ri, wi[row])


@pytest.mark.parametrize("call,n,kw", [
    (dft_matmul.dft_matmul_call, 100, {}),
    (dft_matmul.dft_matmul_call, 2048, {}),
    (fft4step.fft4step_call, 3000, {"n1": 64}),
    (fft4step.fft4step_call, 1 << 17, {"n1": 512}),
])
def test_wrappers_refuse_other_lengths(call, n, kw):
    """A length that is not a power of two (or past the kernel's range)
    raises PlanError on any device."""
    x = tuple(map(torch.from_numpy, _planes(0, (1, n))))
    r = torch.ones(n)
    with pytest.raises(PlanError, match="power of two"):
        call(*x, r, r, **kw)


@pytest.mark.parametrize("call,n,kw", [
    (dft_matmul.dft_matmul_call, 64, {}),
    (fft4step.fft4step_call, 4096, {"n1": 64}),
])
@pytest.mark.parametrize("table", [32, 128])
def test_wrappers_refuse_a_wrong_roots_table(call, n, kw, table):
    x = tuple(map(torch.from_numpy, _planes(1, (2, n))))
    r = tuple(map(torch.from_numpy, tw.roots(table)))
    with pytest.raises(PlanError, match="shape"):
        call(*x, *r, **kw)
