"""The CUDA kernels on the card, against their plain versions.

Marked ``cuda``: they skip on a host without a CUDA device (the CPU tests
cover the plain versions against the reference).  On the card::

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core import fft as F
from repro_torch.core import plan as plan_lib
from repro_torch.kernels import dft_matmul, fft4step, ops, pencil

pytestmark = pytest.mark.cuda

TOL = 1e-4  # kernel vs plain, relative to max|plain|


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return ops.device_key("cuda")


def _planes(dev, *shape, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(
        torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev) for _ in range(2)
    )


def _close(got, want):
    scale = max(want[0].abs().max().item(), want[1].abs().max().item())
    err = max((got[0] - want[0]).abs().max().item(), (got[1] - want[1]).abs().max().item())
    assert err <= TOL * scale, (err, scale)


@pytest.mark.parametrize("b,n", [(3, 2), (5, 16), (70, 100), (33, 1024)])
@pytest.mark.parametrize("epilogue", [False, True])
def test_dft_matmul_kernel(dev, b, n, epilogue):
    x = _planes(dev, b, n)
    w = _planes(dev, n, n, seed=1)
    e = _planes(dev, n, seed=2) if epilogue else None
    _close(dft_matmul.dft_matmul_call(*x, *w, twiddle=e), dft_matmul.dft_matmul_plain(*x, *w, twiddle=e))


@pytest.mark.parametrize("b,n", [(3, 2048), (2, 8192), (2, 32768), (1, 65536)])
@pytest.mark.parametrize("natural", [True, False])
def test_fft4step_kernel(dev, b, n, natural):
    x = _planes(dev, b, n)
    luts = ops._fused_luts(dev, *plan_lib.balanced_split(n), False)
    e = _planes(dev, n, seed=3)
    _close(
        fft4step.fft4step_call(*x, *luts, natural_order=natural, twiddle_after=e),
        fft4step.fft4step_plain(*x, *luts, natural_order=natural, twiddle_after=e),
    )


@pytest.mark.parametrize("n", [1 << 17, 1 << 20, 1 << 22, 1 << 24])
def test_pass_kernels(dev, n):
    cols, rows = plan_lib.plan_fft(n).passes
    b = 2
    x = _planes(dev, b, n)
    _, s, f = cols.view_in
    luts = ops._transform_luts(dev, cols, False)
    tw = ops._pass_twiddle_luts(dev, *cols.twiddle_after, False)
    xv = (x[0].view(b, f, s), x[1].view(b, f, s))
    kw = dict(kind=cols.kind, n1=cols.n1, n2=cols.n2)
    _close(pencil.cols_pass_call(*xv, luts, tw, **kw), pencil.cols_pass_plain(*xv, luts, tw, **kw))
    p, _, f = rows.view_in
    luts = ops._transform_luts(dev, rows, False)
    xv = (x[0].view(b, p, f), x[1].view(b, p, f))
    kw = dict(kind=rows.kind, n1=rows.n1, n2=rows.n2)
    _close(pencil.rows_natural_call(*xv, luts, **kw), pencil.rows_natural_plain(*xv, luts, **kw))


@pytest.mark.parametrize("n", [2, 1024, 4096, 65536, 1 << 18, 1 << 22])
def test_planned_call_launches_one_kernel_per_pass(dev, n):
    x = torch.complex(*_planes(dev, 3, n))
    planned = F.plan(F.FFTSpec(n))
    assert planned.device.type == "cuda"
    kernels.reset_counts()
    y = planned(x)
    counts = kernels.counts()
    assert sum(v for k, v in counts.items() if not k.endswith("_plain")) == len(planned.passes)
    assert sum(v for k, v in counts.items() if k.endswith("_plain")) == 0
    ref = np.fft.fft(x.cpu().numpy().astype(np.complex128))
    assert np.abs(y.cpu().numpy() - ref).max() <= 1e-3 * np.abs(ref).max()
    z = F.plan(F.FFTSpec(n, kind="ifft"))(y)
    assert (z - x).abs().max().item() <= 1e-3 * x.abs().max().item()
