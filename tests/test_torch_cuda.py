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
from repro_torch.kernels import bluestein, build, dft_matmul, fft4step, ops, pencil

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


@pytest.mark.parametrize("b,n", [(3, 2), (5, 16), (70, 64), (33, 1024)])
@pytest.mark.parametrize("epilogue", [False, True])
def test_dft_matmul_kernel(dev, b, n, epilogue):
    x = _planes(dev, b, n)
    inverse = epilogue  # each direction once per shape
    w = ops._roots_luts(dev, n, inverse)
    e = _planes(dev, n, seed=2) if epilogue else None
    _close(dft_matmul.dft_matmul_call(*x, *w, inverse=inverse, twiddle=e),
           dft_matmul.dft_matmul_plain(*x, *w, inverse=inverse, twiddle=e))


@pytest.mark.parametrize("b,n", [(3, 2048), (2, 8192), (2, 32768), (1, 65536)])
@pytest.mark.parametrize("natural", [True, False])
def test_fft4step_kernel(dev, b, n, natural):
    x = _planes(dev, b, n)
    w = ops._roots_luts(dev, n, not natural)
    kw = dict(n1=plan_lib.balanced_split(n)[0], inverse=not natural, natural_order=natural)
    e = _planes(dev, n, seed=3)
    _close(
        fft4step.fft4step_call(*x, *w, twiddle_after=e, **kw),
        fft4step.fft4step_plain(*x, *w, twiddle_after=e, **kw),
    )


@pytest.mark.parametrize("b,n,natural,inverse", [
    (2, 16384, True, False), (3, 16384, False, True), (4, 4096, False, False), (1, 8192, True, True),
])
def test_fft4step_tile_kernel(dev, b, n, natural, inverse):
    """Each whole-signal tile (4096, 8192 and 16384 points) in both orders
    and directions."""
    x = _planes(dev, b, n, seed=4)
    w = ops._roots_luts(dev, n, inverse)
    kw = dict(n1=plan_lib.balanced_split(n)[0], inverse=inverse, natural_order=natural)
    _close(fft4step.fft4step_call(*x, *w, **kw), fft4step.fft4step_plain(*x, *w, **kw))


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


@pytest.mark.parametrize("b,m", [(3, 1), (5, 8), (7, 1000), (64, 8192)])
def test_recomb_kernels(dev, b, m):
    n = 2 * m
    z = _planes(dev, b, m)
    fwd = ops.recomb_luts(dev, n, False)
    _close(pencil.rfft_recomb_call(*z, *fwd), pencil.rfft_recomb_plain(*z, *fwd))
    x = _planes(dev, b, m + 1, seed=1)
    inv = ops.recomb_luts(dev, n, True)
    _close(pencil.irfft_recomb_call(*x, *inv), pencil.irfft_recomb_plain(*x, *inv))


@pytest.mark.parametrize("r,f,s,kind,tw_every", [
    (2, 512, 256 * 16, "direct", 16), (1, 2048, 64 * 32, "fused4", 32), (1, 4096, 16 * 4, "fused4", 4),
])
def test_cols_pass_tw_every_kernel(dev, r, f, s, kind, tw_every):
    x = _planes(dev, r, f, s)
    luts = ops._direct_luts(dev, f, False) if kind == "direct" else ops._fused_luts(
        dev, *plan_lib.balanced_split(f), False)
    n1, n2 = (0, 0) if kind == "direct" else plan_lib.balanced_split(f)
    tw = _planes(dev, f, s // tw_every, seed=4)
    kw = dict(kind=kind, n1=n1, n2=n2, tw_every=tw_every)
    _close(pencil.cols_pass_call(*x, luts, tw, **kw), pencil.cols_pass_plain(*x, luts, tw, **kw))


@pytest.mark.parametrize("r,f,s", [(1, 2048, 8193), (2, 4096, 13), (1, 1024, 1025)])
def test_cols_pass_ragged_kernel(dev, r, f, s):
    x = _planes(dev, r, f, s)
    kind = "direct" if f <= 1024 else "fused4"
    n1, n2 = (0, 0) if kind == "direct" else plan_lib.balanced_split(f)
    luts = ops._direct_luts(dev, f, False) if kind == "direct" else ops._fused_luts(dev, n1, n2, False)
    tw = _planes(dev, f, s, seed=5)
    kw = dict(kind=kind, n1=n1, n2=n2)
    _close(pencil.cols_pass_call(*x, luts, tw, **kw), pencil.cols_pass_plain(*x, luts, tw, **kw))


@pytest.mark.parametrize("b,p,f,w", [(1, 512, 256, 64), (2, 16, 2048, 32), (1, 4, 4096, 8)])
def test_cols_natural_kernel(dev, b, p, f, w):
    x = _planes(dev, b, p, f, w)
    kind = "direct" if f <= 1024 else "fused4"
    n1, n2 = (0, 0) if kind == "direct" else plan_lib.balanced_split(f)
    luts = ops._direct_luts(dev, f, False) if kind == "direct" else ops._fused_luts(dev, n1, n2, False)
    kw = dict(kind=kind, n1=n1, n2=n2)
    _close(pencil.cols_natural_call(*x, luts, **kw), pencil.cols_natural_plain(*x, luts, **kw))


def _launched(fn):
    """Run ``fn`` and return (its output, kernel launches, plain calls)."""
    kernels.reset_counts()
    out = fn()
    counts = kernels.counts()
    launched = sum(v for k, v in counts.items() if not k.endswith("_plain"))
    return out, launched, sum(v for k, v in counts.items() if k.endswith("_plain"))


def _rel(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("n", [2, 16, 4096, 1 << 17, 1 << 21])
def test_planned_rfft_irfft(dev, n):
    x = _planes(dev, 3, n)[0]
    fwd, inv = F.plan(F.FFTSpec(n, kind="rfft")), F.plan(F.FFTSpec(n, kind="irfft"))
    (yr, yi), launched, plain = _launched(lambda: fwd(x))
    assert (launched, plain) == (len(fwd.passes), 0)
    ref = np.fft.rfft(x.cpu().double().numpy())
    assert _rel(yr.cpu().double().numpy() + 1j * yi.cpu().double().numpy(), ref) <= 1e-3
    z, launched, plain = _launched(lambda: inv((yr, yi)))
    assert (launched, plain) == (len(inv.passes), 0)
    assert (z - x).abs().max().item() <= 1e-3 * x.abs().max().item()


@pytest.mark.parametrize("n2,n,kind", [
    (16, 64, "fft2"), (32, 2048, "fft2"), (1 << 17, 8, "fft2"), (1 << 17, 64, "ifft2"),
    (64, 128, "rfft2"), (128, 2048, "rfft2"), (1 << 17, 16, "rfft2"),
])
def test_planned_2d(dev, n2, n, kind):
    rng = np.random.default_rng(n2 + n)
    if kind.startswith("r"):
        x = torch.from_numpy(rng.standard_normal((2, n2, n)).astype(np.float32)).to(dev)
        ref = np.fft.rfft2(x.cpu().double().numpy())
    else:
        x = torch.complex(*_planes(dev, 2, n2, n))
        x128 = x.cpu().numpy().astype(np.complex128)
        ref = np.fft.fft2(x128) if kind == "fft2" else np.fft.ifft2(x128)
    fwd = F.plan(F.FFTSpec(n, kind=kind, n2=n2))
    y, launched, plain = _launched(lambda: fwd(x))
    assert (launched, plain) == (len(fwd.passes), 0)
    got = torch.complex(*y) if isinstance(y, tuple) else y
    assert _rel(got.cpu().numpy().astype(np.complex128), ref) <= 1e-3
    back = {"fft2": "ifft2", "ifft2": "fft2", "rfft2": "irfft2"}[kind]
    inv = F.plan(F.FFTSpec(n, kind=back, n2=n2))
    z, launched, plain = _launched(lambda: inv(y))
    assert (launched, plain) == (len(inv.passes), 0)
    assert (z - x).abs().max().item() <= 1e-3 * x.abs().max().item()


@pytest.mark.parametrize("n,q", [(4096, 33), (1 << 17, 8)])
def test_planned_axis_minus_2(dev, n, q):
    x = torch.complex(*_planes(dev, 2, n, q))
    planned = F.plan(F.FFTSpec(n, axis=-2))
    y, launched, plain = _launched(lambda: planned(x))
    assert (launched, plain) == (len(planned.passes), 0)
    assert planned.kernels[0] == "cols_pass"
    ref = np.fft.fft(x.cpu().numpy().astype(np.complex128), axis=-2)
    assert _rel(y.cpu().numpy(), ref) <= 1e-3


@pytest.mark.parametrize("r,f,s,kind,tw_every", [
    (2, 512, 256 * 12, "direct", 12), (1, 2048, 64 * 500, "fused4", 500), (1, 4096, 16 * 3, "fused4", 3),
])
def test_cols_pass_tw_every_any_width_kernel(dev, r, f, s, kind, tw_every):
    x = _planes(dev, r, f, s)
    luts = ops._direct_luts(dev, f, False) if kind == "direct" else ops._fused_luts(
        dev, *plan_lib.balanced_split(f), False)
    n1, n2 = (0, 0) if kind == "direct" else plan_lib.balanced_split(f)
    tw = _planes(dev, f, s // tw_every, seed=4)
    kw = dict(kind=kind, n1=n1, n2=n2, tw_every=tw_every)
    _close(pencil.cols_pass_call(*x, luts, tw, **kw), pencil.cols_pass_plain(*x, luts, tw, **kw))


@pytest.mark.parametrize("b,n", [(5, 3), (33, 97), (70, 500), (4, 1000), (3, 3000), (2, 12288)])
@pytest.mark.parametrize("inverse", [False, True])
def test_bluestein_fused_kernels(dev, b, n, inverse):
    """Direct inner (M <= 1024), four-step with the intermediate in shared
    memory (M = 2048, 8192) and in the scratch slab (M = 32768)."""
    fwd, inv = plan_lib.plan_fft(n).passes
    m = fwd.n1
    inner = plan_lib._leaf_pass(m)
    kw = dict(n=n, m_pad=m, inner_kind=inner.kind, in1=inner.n1, in2=inner.n2)
    x = _planes(dev, b, n)
    luts = ops._bluestein_luts(dev, fwd, inverse)
    _close(bluestein.bluestein_fwd_call(*x, luts, **kw), bluestein.bluestein_fwd_plain(*x, luts, **kw))
    y = _planes(dev, b, m, seed=1)
    luts = ops._bluestein_luts(dev, inv, inverse)
    _close(bluestein.bluestein_inv_call(*y, luts, **kw), bluestein.bluestein_inv_plain(*y, luts, **kw))


@pytest.mark.parametrize("stage", bluestein.STAGES)
def test_bluestein_elem_kernel(dev, stage):
    n, m = 100003, 1 << 18
    w_in, w_out, w_lut = bluestein._elem_widths(stage, n, m)
    x = _planes(dev, 3, w_in)
    lut = _planes(dev, w_lut, seed=2)
    kw = dict(stage=stage, n=n, m_pad=m)
    _close(bluestein.bluestein_elem_call(*x, lut, **kw), bluestein.bluestein_elem_plain(*x, lut, **kw))


@pytest.mark.parametrize("spec,shape", [
    (F.FFTSpec(500), (9, 500)), (F.FFTSpec(3000, kind="ifft"), (4, 3000)),
    (F.FFTSpec(100003), (2, 100003)), (F.FFTSpec(100003, kind="ifft"), (2, 100003)),
    (F.FFTSpec(4999, kind="rfft"), (3, 4999)), (F.FFTSpec(6000, kind="rfft"), (3, 6000)),
    (F.FFTSpec(500, kind="fft2", n2=1 << 17), (1, 1 << 17, 500)),
    (F.FFTSpec(3000, axis=-2), (3000, 5)),
])
def test_planned_any_length(dev, spec, shape):
    """Every kind at a non-power-of-two length: exactly len(passes)
    launches, the result against np.fft, the inverse back to the input."""
    rng = np.random.default_rng(sum(shape))
    if spec.kind == "rfft":
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
        ref = np.fft.rfft(x.cpu().double().numpy())
        back = F.plan(F.FFTSpec(spec.n, kind="irfft"))
    else:
        x = torch.complex(*_planes(dev, *shape))
        x128 = x.cpu().numpy().astype(np.complex128)
        np_fn = {"fft": np.fft.fft, "ifft": np.fft.ifft}.get(spec.kind, np.fft.fft2)
        ref = np_fn(x128, axis=spec.axis) if spec.kind in ("fft", "ifft") else np_fn(x128)
        inverse = {"fft": "ifft", "ifft": "fft", "fft2": "ifft2"}[spec.kind]
        back = F.plan(F.FFTSpec(spec.n, kind=inverse, axis=spec.axis, n2=spec.n2))
    planned = F.plan(spec)
    y, launched, plain = _launched(lambda: planned(x))
    assert (launched, plain) == (len(planned.passes), 0)
    assert any(k.startswith("bluestein") for k in planned.kernels)
    got = torch.complex(*y) if isinstance(y, tuple) else y
    assert _rel(got.cpu().numpy().astype(np.complex128), ref) <= 1e-3
    z, launched, plain = _launched(lambda: back(y))
    assert (launched, plain) == (len(back.passes), 0)
    assert (z - x).abs().max().item() <= 1e-3 * x.abs().max().item()


def test_register_guard(dev):
    """The fused column kernels stay within their 128-register bound and no
    function uses more local memory than the recorded build gave it."""
    assert build.attribute_faults(build.kernel_attributes()) == []
