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
from repro_torch.kernels import bluestein, build, dft_matmul, fft4step, ops, pencil, ref

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
    w = ops._roots_luts(dev, f, False)
    tw = ops._pass_twiddle_luts(dev, *cols.twiddle_after, False)
    xv = (x[0].view(b, f, s), x[1].view(b, f, s))
    _close(pencil.cols_pass_call(*xv, *w, tw, n1=cols.n1), pencil.cols_pass_plain(*xv, *w, tw))
    p, _, f = rows.view_in
    w = ops._roots_luts(dev, f, False)
    xv = (x[0].view(b, p, f), x[1].view(b, p, f))
    _close(pencil.rows_natural_call(*xv, *w, n1=rows.n1), pencil.rows_natural_plain(*xv, *w))


@pytest.mark.parametrize("f,tile", [(256, 12), (256, 13), (512, 14), (1024, 13), (2048, 14),
                                    (4096, 14), (4096, pencil.SLAB), (16384, 14),
                                    (16384, pencil.SLAB), (65536, pencil.SLAB)])
@pytest.mark.parametrize("inverse", [False, True])
def test_radix_pass_forms_kernel(dev, f, tile, inverse):
    """The three radix passes in every form (on-chip tiles of 2^12..2^14
    points, the slab four-step) at a ragged width and row count."""
    w = ops._roots_luts(dev, f, inverse)
    x = _planes(dev, 2, f, 11)
    tw = _planes(dev, f, 11, seed=3)
    kw = dict(inverse=inverse)
    _close(pencil._launch_cols(*x, *w, tw, inverse, 0, 1, tile),
           pencil.cols_pass_plain(*x, *w, tw, **kw))
    x = _planes(dev, 2, 11, f, seed=1)
    _close(pencil._launch_rows(*x, *w, inverse, 0, tile), pencil.rows_natural_plain(*x, *w, **kw))
    x = _planes(dev, 2, 3, f, 11, seed=2)
    _close(pencil._launch_cols_natural(*x, *w, inverse, 0, tile),
           pencil.cols_natural_plain(*x, *w, **kw))


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


@pytest.mark.parametrize("r,f,s,tile,tw_every", [
    (2, 512, 256 * 16, None, 16), (1, 2048, 64 * 32, None, 32), (1, 4096, 16 * 4, pencil.SLAB, 4),
])
def test_cols_pass_tw_every_kernel(dev, r, f, s, tile, tw_every):
    x = _planes(dev, r, f, s)
    w = ops._roots_luts(dev, f, False)
    tw = _planes(dev, f, s // tw_every, seed=4)
    _close(pencil._launch_cols(*x, *w, tw, False, 0, tw_every, tile),
           pencil.cols_pass_plain(*x, *w, tw, tw_every=tw_every))


@pytest.mark.parametrize("r,f,s,tile", [(1, 2048, 8193, None), (2, 4096, 13, pencil.SLAB),
                                        (1, 1024, 1025, None), (1, 16384, 9, None)])
def test_cols_pass_ragged_kernel(dev, r, f, s, tile):
    x = _planes(dev, r, f, s)
    w = ops._roots_luts(dev, f, False)
    tw = _planes(dev, f, s, seed=5)
    _close(pencil._launch_cols(*x, *w, tw, False, 0, 1, tile), pencil.cols_pass_plain(*x, *w, tw))


@pytest.mark.parametrize("b,p,f,w", [(1, 512, 256, 64), (2, 16, 2048, 32), (1, 4, 4096, 8),
                                     (2, 8, 1024, 70)])
@pytest.mark.parametrize("inverse", [False, True])
def test_cols_natural_kernel(dev, b, p, f, w, inverse):
    """cols_natural in each form its table picks (the 2^13 tile, the 2^14
    tile at f = 2048, the slab from 4096) and at a ragged width, both
    directions, on the roots table."""
    x = _planes(dev, b, p, f, w)
    rr = ops._roots_luts(dev, f, inverse)
    n1 = plan_lib.balanced_split(f)[0] if f > 1024 else 0
    _close(pencil.cols_natural_call(*x, *rr, n1=n1, inverse=inverse),
           pencil.cols_natural_plain(*x, *rr, inverse=inverse))


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


@pytest.mark.parametrize("r,f,s,tile,tw_every", [
    (2, 512, 256 * 12, None, 12), (1, 2048, 64 * 500, None, 500), (1, 4096, 16 * 3, pencil.SLAB, 3),
])
def test_cols_pass_tw_every_any_width_kernel(dev, r, f, s, tile, tw_every):
    x = _planes(dev, r, f, s)
    w = ops._roots_luts(dev, f, False)
    tw = _planes(dev, f, s // tw_every, seed=4)
    _close(pencil._launch_cols(*x, *w, tw, False, 0, tw_every, tile),
           pencil.cols_pass_plain(*x, *w, tw, tw_every=tw_every))


@pytest.mark.parametrize("b,n", [(5, 3), (33, 97), (70, 500), (4, 1000), (3, 3000), (2, 4999),
                                 (2, 12288), (1, 20000)])
@pytest.mark.parametrize("inverse", [False, True])
def test_bluestein_fused_kernels(dev, b, n, inverse):
    """Every form of the radix stages: the 4096-point tile (M = 8 … 2048,
    many signals a block, ragged last blocks), the 8192- and 16384-point
    tiles (n = 3000, 4999) and the slab four-step (M = 32768, 65536)."""
    fwd, inv = plan_lib.plan_fft(n).passes
    m = fwd.n1
    kw = dict(n=n, m_pad=m)
    in1 = plan_lib._leaf_pass(m).n1
    x = _planes(dev, b, n)
    luts = ops._bluestein_luts(dev, fwd, inverse)
    _close(bluestein.bluestein_fwd_call(*x, luts, in1=in1, **kw),
           bluestein.bluestein_fwd_plain(*x, luts, **kw))
    y = _planes(dev, b, m, seed=1)
    luts = ops._bluestein_luts(dev, inv, inverse)
    _close(bluestein.bluestein_inv_call(*y, luts, in1=in1, **kw),
           bluestein.bluestein_inv_plain(*y, luts, **kw))


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


#: Every kind at a power-of-two length, a Bluestein length and a two-pass
#: length, the 2-D kinds and the column axis, each over a batch of 0.
EMPTY = [F.FFTSpec(n, kind=k) for n in (1024, 1000, 1 << 20) for k in ("fft", "ifft", "rfft", "irfft")]
EMPTY += [F.FFTSpec(64, kind=k, n2=16) for k in ("fft2", "ifft2", "rfft2", "irfft2")]
EMPTY += [F.FFTSpec(1000, kind="fft2", n2=16), F.FFTSpec(1000, axis=-2), F.FFTSpec(1024, axis=-2)]


@pytest.mark.parametrize("spec", EMPTY, ids=str)
def test_empty_batch_on_the_card(dev, spec):
    """A batch of 0 on the card: np.fft's shape in the port's dtype, no
    launch and no plain call."""
    n = spec.n // 2 + 1 if spec.kind.startswith("irfft") else spec.n
    shape = (0, spec.n2, n) if spec.n2 else (0, n, 3) if spec.axis == -2 else (0, n)
    x = np.zeros(shape, np.float32 if spec.kind.startswith("rfft") else np.complex64)
    planned = F.plan(spec)
    y, launched, plain = _launched(lambda: planned(torch.from_numpy(x).to(dev)))
    y = torch.complex(*y) if isinstance(y, tuple) else y
    assert (launched, plain) == (0, 0)
    assert y.device.type == "cuda" and tuple(y.shape) == ref.np_fft(spec, x).shape
    assert y.dtype == (torch.float32 if spec.kind.startswith("irfft") else torch.complex64)


def test_register_guard(dev):
    """No function uses more local memory than the recorded build gave it,
    and the radix functions (#2, #3, #4, #5, #7, #8) have the recorded
    registers."""
    attrs = build.kernel_attributes()
    assert build.attribute_faults(attrs) == []
    for name, row in attrs.items():
        if name.startswith(("cols_radix", "cols_slab", "rows_radix", "rows_slab", "fft4step",
                            "bluestein_fwd", "bluestein_inv")):
            assert (row["registers"], row["local_bytes"]) == build.RECORDED_ATTRS[name]


# ---------------------------------------------------------------------------
# the convolution layer on the card, against the same call on the CPU
# ---------------------------------------------------------------------------


def _conv_inputs(xs, hs, seed=5):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal(xs).astype(np.float32)),
            torch.from_numpy(rng.standard_normal(hs).astype(np.float32)))


def _card_vs_cpu(fn):
    """``fn(device)`` on the card (kernels only, no plain call) and on the
    CPU, within 1e-3·max|cpu|; returns the card's launches."""
    want = fn("cpu")
    got, launched, plain = _launched(lambda: fn("cuda"))
    assert plain == 0 and launched > 0
    assert got.device.type == "cuda"
    assert _rel(got.cpu().double().numpy(), want.double().numpy()) <= 1e-3
    return launched


@pytest.mark.parametrize("xs,hs,kw", [
    ((2, 4, 3000), (4, 129), {}),
    ((2, 300, 16), (16, 33), {"axis": 1}),
    ((3, 3000), (1001,), {"pad": "exact"}),
    ((1, 1 << 16), (129,), {}),  # auto-routed to overlap-save
])
def test_fft_conv_on_the_card(dev, xs, hs, kw):
    from repro_torch.core import conv

    x, h = _conv_inputs(xs, hs)
    _card_vs_cpu(lambda d: conv.fft_conv(x.to(d), h.to(d), **kw))


def test_fft_conv_os_and_streaming_on_the_card(dev):
    from repro_torch.core import overlap

    x, h = _conv_inputs((2, 20000), (257,))
    n_os = _card_vs_cpu(lambda d: overlap.fft_conv_os(x.to(d), h.to(d), block=4096))
    spec = [F.plan(F.FFTSpec(4096, kind=k)) for k in ("rfft", "irfft")]
    assert n_os == 2 * len(spec[0].passes) + len(spec[1].passes)

    def stream(d):
        sc = overlap.StreamingConv(h.to(d), block=4096)
        state, outs, pos = sc.init_state((2,)), [], 0
        for c in (5000, 17, 9000, 5983):
            y, state = sc(x[:, pos:pos + c].to(d), state)
            outs.append(y)
            pos += c
        return torch.cat(outs, dim=-1)

    _card_vs_cpu(stream)


def test_spectral_mixer_stream_decode_on_the_card(dev):
    from repro_torch.models.layers.spectral import SpectralMixer

    rng = np.random.default_rng(6)
    x = torch.from_numpy((0.5 * rng.standard_normal((2, 300, 64))).astype(np.float32))

    def run(d):
        m = SpectralMixer(64, 128, device=d, generator=torch.Generator().manual_seed(1))
        with torch.no_grad():
            _, cache = m(x[:, :200].to(d), return_cache=True)
            outs = []
            for t in range(200, 300):  # 100 tokens, C = 32: three flushes
                y, cache = m.stream_decode(x[:, t:t + 1].to(d), cache)
                outs.append(y)
        return torch.cat(outs, dim=1)

    _card_vs_cpu(run)


def test_served_lm_on_the_card(dev):
    """The reduced spectral hybrid served on the card (a request inserted
    into the running batch, past a stream flush): the same tokens as the
    CPU route, and the teacher-forced logits within 1e-3."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.configs.reduce import make_reduced
    from repro_torch.models.model import DecoderLM
    from repro_torch.serving.engine import Engine, ServeConfig
    from repro_torch.serving.spectral_serve import ServeSession

    cfg = make_reduced(dataclasses.replace(get_config("h2o-danube-1.8b"), use_spectral_mixer=True))
    cfg = dataclasses.replace(cfg, compute_dtype="float32")
    prompts = np.random.default_rng(7).integers(4, 512, (2, 40))
    served = {}

    def run(d):
        model = DecoderLM(cfg, device=d, generator=torch.Generator().manual_seed(0))
        sess = ServeSession(Engine(model, ServeConfig(eos_id=-1)), slots=2, max_len=80)
        sess.submit(prompts[0])
        sess.run(5)
        sess.submit(prompts[1])
        sess.run(12)
        served[d] = [sess.output(s) for s in range(2)]
        seq = torch.tensor([list(prompts[0]) + served[d][0][:-1]], device=d)
        with torch.no_grad():
            return model.logits_fn(seq)

    _card_vs_cpu(run)
    assert served["cuda"] == served["cpu"]


def test_measured_plan_matches_the_heuristic_plan(dev, tmp_path, monkeypatch):
    # tune="measure" times its candidates on the card (CUDA events) and
    # returns a plan whose output is the heuristic plan's; planning it
    # again measures nothing.
    from repro_torch.core import tuning

    monkeypatch.setenv("REPRO_TUNING_CACHE", str(tmp_path / "tuning.json"))
    tuning.cache.clear()
    tuning.clear_measure_log()
    for spec in (F.FFTSpec(1024, batch_hint=256), F.FFTSpec(1 << 17, kind="ifft", batch_hint=4),
                 F.FFTSpec(512, kind="fft2", n2=1 << 17, batch_hint=1)):
        measured = F.plan(spec, device=dev, tune="measure")
        off = F.plan(spec, device=dev, tune="off")
        assert measured.tuned is not None and off.tuned is None
        shape = (1, spec.n2, spec.n) if spec.n2 else (spec.batch_hint, spec.n)
        x = torch.complex(*_planes(dev, *shape))
        got, want = measured(x), off(x)
        _close((got.real, got.imag), (want.real, want.imag))
        logged = len(tuning.measure_log())
        assert logged > 0
        monkeypatch.setattr(tuning, "cache", tuning.TuningCache())  # a fresh object reads the file
        F._plan_cached.cache_clear()
        F.plan(spec, device=dev, tune="measure")
        assert len(tuning.measure_log()) == logged
    tuning.cache.clear()


# ---------------------------------------------------------------------------
# gradients and training on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec,shape", [
    (F.FFTSpec(1024), (4, 1024)),
    (F.FFTSpec(8192, kind="rfft"), (3, 8192)),
    (F.FFTSpec(8192, kind="irfft"), (3, 4097)),
    (F.FFTSpec(3000, kind="ifft"), (2, 3000)),
    (F.FFTSpec(1 << 17), (1, 1 << 17)),
    (F.FFTSpec(256, kind="fft2", n2=1 << 12), (1, 1 << 12, 256)),
    (F.FFTSpec(4096, axis=-2), (4096, 8)),
])
def test_planned_backward_on_the_card(dev, spec, shape):
    """With grad enabled a planned call's output is attached to the graph on
    the card; its vjp launches exactly the opposite direction's kernels (no
    plain call) and matches the CPU route's."""
    real_in = spec.kind == "rfft"
    rng = np.random.default_rng(0)
    ins = [rng.standard_normal(shape).astype(np.float32) for _ in range(1 if real_in else 2)]
    grads, counts = {}, None
    for d in ("cpu", dev):
        planned = F.plan(spec, device=d)
        xs = [torch.from_numpy(a).to(d).requires_grad_(True) for a in ins]
        y = planned(xs[0]) if real_in else planned(tuple(xs))
        outs = [y] if torch.is_tensor(y) else list(y)
        assert all(o.requires_grad for o in outs)
        crng = np.random.default_rng(1)
        cots = [torch.from_numpy(crng.standard_normal(tuple(o.shape)).astype(np.float32)).to(d) for o in outs]
        kernels.reset_counts()
        grads[d] = torch.autograd.grad(outs, xs, cots)
        torch.cuda.synchronize()
        counts = kernels.counts()
    other = F.plan(F.FFTSpec(spec.n, kind={"fft": "ifft", "ifft": "fft", "rfft": "irfft", "irfft": "rfft",
                                           "fft2": "ifft2"}[spec.kind], axis=spec.axis, n2=spec.n2), device=dev)
    assert {k: v for k, v in counts.items() if v} == {k: other.kernels.count(k) for k in set(other.kernels)}
    for g, w in zip(grads[dev], grads["cpu"]):
        assert _rel(g.cpu().double().numpy(), w.double().numpy()) <= 1e-3


def test_mixer_and_train_step_on_the_card(dev):
    """The reduced hybrid LM with a 1024-tap filter (its convs at n = 4096,
    fft4step): one SGD step on the card and on the CPU from the same
    weights and batch, the loss and every updated parameter within
    1e-3·max|cpu| (float32 compute, remat on), no plain call on the card."""
    import dataclasses

    from repro_torch.configs.base import TrainConfig, get_config
    from repro_torch.configs.reduce import make_reduced
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.train.train_loop import init_train_state, make_train_step

    cfg = dataclasses.replace(make_reduced(dataclasses.replace(get_config("h2o-danube-1.8b"),
                                                                use_spectral_mixer=True)),
                              compute_dtype="float32", spectral_filter_len=1024)
    tc = TrainConfig(optimizer="sgd", learning_rate=1e-2)
    batch = make_batch(DataConfig(cfg.vocab_size, 2048, 2), 0)
    out = {}
    for d in ("cpu", dev):
        st = init_train_state(cfg, tc, device="cpu", generator=torch.Generator().manual_seed(0))
        st = st._replace(model=st.model.to(d))
        kernels.reset_counts()
        st, metrics = make_train_step(cfg, tc)(st, batch)
        counts = kernels.counts()
        out[d] = (float(metrics["loss"]), {n: p.detach().cpu() for n, p in st.model.named_parameters()})
    assert not any(v for k, v in counts.items() if k.endswith("_plain"))
    assert counts["fft4step"] > 0 and counts["rfft_recomb"] > 0 and counts["irfft_recomb"] > 0
    assert abs(out[dev][0] - out["cpu"][0]) <= 1e-3 * abs(out["cpu"][0])
    for n, p in out["cpu"][1].items():
        assert _rel(out[dev][1][n].double().numpy(), p.double().numpy()) <= 1e-3, n
