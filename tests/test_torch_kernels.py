"""Each kernel's plain PyTorch version against its Pallas kernel.

The Pallas kernels run as the reference's own tests run them on the CPU
(interpret mode).  Same LUTs, same algorithm, so the tolerance is
1e-5·max|ref|: float32 rounding of reordered sums, nothing more.  The port's
wrappers are called on CPU tensors, where each takes its plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import twiddle as ref_tw
from repro.kernels import pencil as ref_pencil
from repro.kernels.dft_matmul import dft_matmul_call as ref_dft_matmul
from repro.kernels.fft4step import fft4step_call as ref_fft4step
from repro_torch import kernels
from repro_torch.core import twiddle as tw
from repro_torch.core.faults import PlanError
from repro_torch.kernels import dft_matmul, fft4step, pencil

TOL = 1e-5


def _planes(seed, shape):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal(shape).astype(np.float32),
        rng.standard_normal(shape).astype(np.float32),
    )


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(mine, ref):
    ref = [np.asarray(a) for a in ref]
    scale = max(np.abs(ref[0]).max(), np.abs(ref[1]).max())
    for a, b in zip(mine, ref):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=TOL * scale)


def _fused_luts(n1, n2):
    return (*ref_tw.dft_matrix(n1), *ref_tw.twiddle_grid(n1, n2), *ref_tw.dft_matrix(n2))


def _counted(name, fn):
    """Run ``fn`` and check it took exactly one plain call and no launch."""
    kernels.reset_counts()
    out = fn()
    counts = kernels.counts()
    assert counts[f"{name}_plain"] == 1 and counts[name] == 0, counts
    return out


@pytest.mark.parametrize("n", [2, 16, 1024])
@pytest.mark.parametrize("epilogue", [False, True])
def test_dft_matmul(n, epilogue):
    """The port's radix leaf (its plain version, the Stockham FFT over the
    roots table) against the Pallas DFT-matrix kernel, both tables from the
    same twiddle module, forward with the epilogue and inverse without."""
    b = 3
    inverse = not epilogue
    x = _planes(n, (b, n))
    w = ref_tw.dft_matrix(n, inverse)
    if inverse:
        w = tuple(a / np.float32(n) for a in w)  # the reference folds 1/N into W
    roots = tw.roots(n, inverse)
    e = _planes(n + 1, (n,)) if epilogue else None
    mine = _counted("dft_matmul", lambda: dft_matmul.dft_matmul_call(
        *_t(*x, *roots), inverse=inverse, twiddle=_t(*e) if e else None))
    ref = ref_dft_matmul(*_j(*x, *w), batch_tile=b, twiddle=_j(*e) if e else None, interpret=True)
    _close(mine, ref)


@pytest.mark.parametrize("n1,n2", [(64, 32), (64, 64)])
@pytest.mark.parametrize("order,epilogue", [("natural", False), ("pencil", False), ("natural", True)])
def test_fft4step(n1, n2, order, epilogue):
    n, b = n1 * n2, 2
    x = _planes(n, (b, n))
    luts = _fused_luts(n1, n2)
    e = _planes(n + 1, (n,)) if epilogue else None
    natural = order == "natural"
    mine = _counted("fft4step", lambda: fft4step.fft4step_call(
        *_t(*x, *tw.roots(n)), n1=n1, natural_order=natural,
        twiddle_after=_t(*e) if e else None))
    ref = ref_fft4step(*_j(*x, *luts), batch_tile=1, natural_order=natural,
                       twiddle_after=_j(*e) if e else None, interpret=True)
    _close(mine, ref)


def _pass_luts(kind, f, n1, n2):
    return ref_tw.dft_matrix(f) if kind == "direct" else _fused_luts(n1, n2)


@pytest.mark.parametrize("kind,f,n1,n2", [("direct", 512, 0, 0), ("fused4", 2048, 64, 32)])
@pytest.mark.parametrize("with_twiddle", [True, False])
def test_cols_pass(kind, f, n1, n2, with_twiddle):
    r, s = 2, 16
    x = _planes(f, (r, f, s))
    luts = _pass_luts(kind, f, n1, n2)
    tw = ref_tw.pass_twiddle(f, s) if with_twiddle else None
    mine = _counted("cols_pass", lambda: pencil.cols_pass_call(
        *_t(*x), _t(*luts), _t(*tw) if tw else None, kind=kind, n1=n1, n2=n2))
    ref = ref_pencil.cols_pass_call(*_j(*x), _j(*luts), _j(*tw) if tw else None,
                                    kind=kind, n1=n1, n2=n2, chunk=8, interpret=True)
    _close(mine, ref)


@pytest.mark.parametrize("kind,f,n1,n2", [("direct", 256, 0, 0), ("fused4", 2048, 64, 32)])
def test_rows_natural(kind, f, n1, n2):
    b, p = 2, 16
    x = _planes(f + 7, (b, p, f))
    luts = _pass_luts(kind, f, n1, n2)
    mine = _counted("rows_natural", lambda: pencil.rows_natural_call(
        *_t(*x), _t(*luts), kind=kind, n1=n1, n2=n2))
    ref = ref_pencil.rows_natural_call(*_j(*x), _j(*luts), kind=kind, n1=n1, n2=n2,
                                       chunk=8, interpret=True)
    _close(mine, ref)


@pytest.mark.parametrize("kind,f,n1,n2", [("direct", 256, 0, 0), ("fused4", 2048, 64, 32)])
@pytest.mark.parametrize("tw_every", [8, 16])
def test_cols_pass_tw_every(kind, f, n1, n2, tw_every):
    """The width-broadcast twiddle of a strip-mined column factor: one
    (f, s / tw_every) grid column per run of tw_every image columns."""
    r, s = 2, 64
    x = _planes(f + tw_every, (r, f, s))
    luts = _pass_luts(kind, f, n1, n2)
    tw = ref_tw.pass_twiddle(f, s // tw_every)
    mine = _counted("cols_pass", lambda: pencil.cols_pass_call(
        *_t(*x), _t(*luts), _t(*tw), kind=kind, n1=n1, n2=n2, tw_every=tw_every))
    ref = ref_pencil.cols_pass_call(*_j(*x), _j(*luts), _j(*tw), kind=kind, n1=n1, n2=n2,
                                    chunk=8, interpret=True, tw_every=tw_every)
    _close(mine, ref)


@pytest.mark.parametrize("kind,f,n1,n2", [("direct", 256, 0, 0), ("fused4", 2048, 64, 32)])
def test_cols_natural(kind, f, n1, n2):
    b, p, w = 2, 4, 16
    x = _planes(f + 3, (b, p, f, w))
    luts = _pass_luts(kind, f, n1, n2)
    mine = _counted("cols_natural", lambda: pencil.cols_natural_call(
        *_t(*x), _t(*luts), kind=kind, n1=n1, n2=n2))
    ref = ref_pencil.cols_natural_call(*_j(*x), _j(*luts), kind=kind, n1=n1, n2=n2,
                                       chunk=8, interpret=True)
    _close(mine, ref)


@pytest.mark.parametrize("m", [1, 8, 1024])
def test_recomb(m):
    n, b = 2 * m, 3
    z = _planes(m, (b, m))
    w = ref_tw.rfft_recomb_twiddle(n)
    mine = _counted("rfft_recomb", lambda: pencil.rfft_recomb_call(*_t(*z, *w)))
    ref = ref_pencil.rfft_recomb_call(*_j(*z, *w), interpret=True)
    _close(mine, ref)
    x = _planes(m + 1, (b, m + 1))
    w = ref_tw.rfft_recomb_twiddle(n, inverse=True)
    mine = _counted("irfft_recomb", lambda: pencil.irfft_recomb_call(*_t(*x, *w)))
    ref = ref_pencil.irfft_recomb_call(*_j(*x, *w), interpret=True)
    _close(mine, ref)


def test_wrappers_validate_operands():
    xr, xi = _t(*_planes(0, (2, 16)))
    rr, ri = _t(*tw.roots(16))
    wr, wi = _t(*ref_tw.dft_matrix(16))
    with pytest.raises(PlanError, match="float32"):
        dft_matmul.dft_matmul_call(xr.double(), xi, rr, ri)
    with pytest.raises(PlanError, match="shape"):
        dft_matmul.dft_matmul_call(xr, xi, rr[:8], ri)
    with pytest.raises(PlanError, match="contiguous"):
        dft_matmul.dft_matmul_call(xr, xi, wr[:, 0], wi[:, 0])
    with pytest.raises(PlanError, match="n1"):
        fft4step.fft4step_call(*_t(*_planes(1, (1, 2048)), *tw.roots(2048)), n1=16)
    with pytest.raises(PlanError, match="kind"):
        pencil.rows_natural_call(xr.view(1, 2, 16), xi.view(1, 2, 16), (wr, wi), kind="bogus")
    with pytest.raises(PlanError, match="LUT"):
        pencil.cols_pass_call(xr.view(1, 16, 2), xi.view(1, 16, 2), (wr,), kind="direct")
    with pytest.raises(PlanError, match="tw_every"):
        pencil.cols_pass_call(xr.view(1, 16, 2), xi.view(1, 16, 2), (wr, wi), kind="direct",
                              tw_every=3)
    with pytest.raises(PlanError, match="shape"):
        pencil.rfft_recomb_call(xr, xi, wr[0], wi[0])  # the LUT must hold m + 1 phasors


@pytest.mark.parametrize("n1,n2", [(4, 2), (8, 8), (32, 16)])
@pytest.mark.parametrize("inverse", [False, True])
def test_numpy_oracles_equal_the_reference(n1, n2, inverse):
    from repro.kernels import ref as ref_oracles
    from repro_torch.kernels import ref

    x = _planes(n1 * n2, (3, n1 * n2))
    x = x[0] + 1j * x[1]
    np.testing.assert_array_equal(ref.naive_dft(x, inverse), ref_oracles.naive_dft(x, inverse))
    np.testing.assert_array_equal(
        ref.four_step_ref(x, n1, n2, inverse), ref_oracles.four_step_ref(x, n1, n2, inverse)
    )
    np.testing.assert_allclose(ref.four_step_ref(x, n1, n2, inverse), ref.naive_dft(x, inverse), atol=1e-9 * np.abs(x).sum())
