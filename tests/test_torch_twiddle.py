"""The port's LUT tables are bit-equal to the reference's."""

import numpy as np
import pytest

from repro.core import twiddle as ref_tw
from repro_torch.core import twiddle as tw


def _same(a, b):
    assert len(a) == len(b) == 2
    for x, y in zip(a, b):
        assert x.dtype == y.dtype == np.float32
        assert np.array_equal(x, y)


@pytest.mark.parametrize("n", [1, 2, 16, 1024, 2048])
@pytest.mark.parametrize("inverse", [False, True])
def test_dft_matrix(n, inverse):
    _same(tw.dft_matrix(n, inverse), ref_tw.dft_matrix(n, inverse))


@pytest.mark.parametrize("n1,n2", [(64, 32), (256, 256), (512, 256), (2048, 2048), (2, 1 << 21)])
@pytest.mark.parametrize("inverse", [False, True])
def test_twiddle_and_pass_grids(n1, n2, inverse):
    _same(tw.twiddle_grid(n1, n2, inverse), ref_tw.twiddle_grid(n1, n2, inverse))
    _same(tw.pass_twiddle(n1, n2, inverse), ref_tw.pass_twiddle(n1, n2, inverse))


@pytest.mark.parametrize("inverse", [False, True])
def test_numpy_only_rest(inverse):
    for l in (1, 8, 512):
        _same(tw.stage_twiddle(l, inverse), ref_tw.stage_twiddle(l, inverse))
    for n in (3, 1000):
        _same(tw.bluestein_chirp(n, inverse), ref_tw.bluestein_chirp(n, inverse))
        _same(tw.bluestein_postchirp(n, inverse), ref_tw.bluestein_postchirp(n, inverse))
        pad = 1 << (2 * n - 1).bit_length()
        _same(tw.bluestein_spectrum(n, pad, inverse), ref_tw.bluestein_spectrum(n, pad, inverse))
    for n in (2, 64, 1000):
        _same(tw.rfft_recomb_twiddle(n, inverse), ref_tw.rfft_recomb_twiddle(n, inverse))


def test_dft_matrix_rejects_non_pow2():
    with pytest.raises(ValueError):
        tw.dft_matrix(12)
