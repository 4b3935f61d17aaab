"""Gradients through every planned transform, the convolutions and the
spectral mixer on the CPU route, against ``jax.vjp`` / ``jax.grad`` of the
reference (``backend="xla"``, ``tune="off"``).

The port differentiates through two autograd leaves (``core/fft.py``'s
``_PassProgram`` and ``_Recomb``), which the CPU route runs exactly as the
card does, with each kernel's plain version in place of its launch.  Inputs
and cotangents are seeded numpy arrays whose imaginary parts at bins 0 and
n/2 are nonzero: the recombination reads them (this package's irfft, like
the reference's, is not ``np.fft.irfft`` there), so its gradient writes
them.  Tolerance: 1e-5·max|ref| per gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig
from repro.core import conv as ref_conv
from repro.core import fft as ref_fft
from repro.core import overlap as ref_overlap
from repro.models.layers import spectral as ref_spec
from repro.utils.params import unzip
from repro_torch import kernels
from repro_torch.core import conv as C
from repro_torch.core import fft as F
from repro_torch.core import overlap
from repro_torch.models.layers.spectral import SpectralMixer
from repro_torch.utils.params import load_reference_params

TOL = 1e-5


@pytest.fixture(autouse=True)
def _reference_untuned(monkeypatch):
    monkeypatch.setenv("REPRO_FFT_TUNE", "off")


def _a(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _rel(got, ref):
    got = got.detach().numpy().astype(np.float64) if torch.is_tensor(got) else np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


def _out_shape(spec, shape):
    """The planes' shape of ``spec``'s output for an input of ``shape``."""
    shape = list(shape)
    if spec.kind in ("rfft", "rfft2"):
        shape[spec.axis] = spec.n // 2 + 1
    elif spec.kind in ("irfft", "irfft2"):
        shape[spec.axis] = spec.n
    return tuple(shape)


def _vjp_pair(spec, shape, seed=0):
    """The port's and the reference's vector-Jacobian products of ``spec``
    at a seeded input of ``shape`` (planes for complex and irfft kinds, a
    real signal for the rfft kinds) and a seeded cotangent."""
    real_in = spec.kind in ("rfft", "rfft2")
    real_out = spec.kind in ("irfft", "irfft2")
    ins = [_a(shape, seed)] if real_in else [_a(shape, seed), _a(shape, seed + 1)]
    out = _out_shape(spec, shape)
    cots = [_a(out, seed + 2)] if real_out else [_a(out, seed + 2), _a(out, seed + 3)]

    ref_planned = ref_fft.plan(ref_fft.FFTSpec(spec.n, kind=spec.kind, axis=spec.axis, n2=spec.n2),
                               backend="xla", tune="off")
    ref_fn = (lambda x: ref_planned(x)) if real_in else (lambda xr, xi: ref_planned((xr, xi)))
    _, vjp = jax.vjp(ref_fn, *map(jnp.asarray, ins))
    ref = vjp(jnp.asarray(cots[0]) if real_out else tuple(map(jnp.asarray, cots)))

    planned = F.plan(spec, device="cpu")
    xs = [_t(a, grad=True) for a in ins]
    got_y = planned(xs[0]) if real_in else planned(tuple(xs))
    outs = [got_y] if real_out else list(got_y)
    got = torch.autograd.grad(outs, xs, [_t(c) for c in cots])
    return got, ref


CASES = [
    (F.FFTSpec(16), (3, 16)),
    (F.FFTSpec(16, kind="ifft"), (3, 16)),
    (F.FFTSpec(4096), (2, 4096)),  # fft4step
    (F.FFTSpec(1 << 17, kind="ifft"), (1, 1 << 17)),  # cols_pass + rows_natural
    (F.FFTSpec(12), (3, 12)),  # Bluestein
    (F.FFTSpec(100, kind="ifft"), (2, 100)),
    (F.FFTSpec(16, axis=-2), (2, 16, 5)),  # one in-place column pass
    (F.FFTSpec(12, axis=-2), (16, 12, 3)),  # Bluestein down the columns
    (F.FFTSpec(8, axis=0), (8, 2, 3)),
    (F.FFTSpec(16, kind="rfft"), (3, 16)),
    (F.FFTSpec(16, kind="irfft"), (3, 9)),
    (F.FFTSpec(4096, kind="rfft"), (2, 4096)),
    (F.FFTSpec(4096, kind="irfft"), (2, 2049)),
    (F.FFTSpec(12, kind="rfft"), (2, 12)),  # even non-pow2: Bluestein child + recombination
    (F.FFTSpec(12, kind="irfft"), (2, 7)),
    (F.FFTSpec(15, kind="rfft"), (2, 15)),  # odd: one complex Bluestein child
    (F.FFTSpec(15, kind="irfft"), (2, 8)),
    (F.FFTSpec(16, kind="rfft", axis=0), (16, 3)),
    (F.FFTSpec(16, kind="irfft", axis=0), (9, 3)),
    (F.FFTSpec(16, kind="fft2", n2=8), (2, 8, 16)),
    (F.FFTSpec(12, kind="ifft2", n2=8), (2, 8, 12)),
    (F.FFTSpec(16, kind="rfft2", n2=8), (2, 8, 16)),
    (F.FFTSpec(16, kind="irfft2", n2=8), (2, 8, 9)),
]


@pytest.mark.parametrize("spec,shape", CASES, ids=lambda v: v.kind + str(v.n) + f"ax{v.axis}"
                         if isinstance(v, F.FFTSpec) else "x".join(map(str, v)))
def test_vjp_matches_reference(spec, shape):
    got, ref = _vjp_pair(spec, shape)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert _rel(g, r) <= TOL


def test_split_regime_vjp_matches_reference():
    """A Bluestein length past the fused regime: the split chirp stages."""
    got, ref = _vjp_pair(F.FFTSpec(70001), (1, 70001))
    assert F.plan(F.FFTSpec(70001), device="cpu").kernels.count("bluestein_elem") > 0
    for g, r in zip(got, ref):
        assert _rel(g, r) <= TOL


@pytest.mark.parametrize("n", [16, 1024, 30])
def test_rfft_adjoint_identity(n):
    """rfft's vjp is n·irfft(w ⊙ P(g)): w is 1 at bins 0 and n/2 and ½
    elsewhere, P drops the imaginary part at bins 0 and n/2 (rfft's outputs
    there are real whatever the input).  Without P it would not hold."""
    m = n // 2
    x = _t(_a((3, n), 0), grad=True)
    gr, gi = _t(_a((3, m + 1), 1)), _t(_a((3, m + 1), 2))
    (got,) = torch.autograd.grad(F.plan(F.FFTSpec(n, kind="rfft"), device="cpu")(x), x, (gr, gi))
    w = torch.full((m + 1,), 0.5)
    w[0] = w[m] = 1.0
    pi = gi.clone()
    pi[:, 0] = pi[:, m] = 0.0
    irfft = F.plan(F.FFTSpec(n, kind="irfft"), device="cpu")
    assert _rel(got, n * irfft((w * gr, w * pi))) <= TOL
    assert _rel(got, n * irfft((w * gr, w * gi))) > 1e-2


def test_irfft_reads_the_end_bins_imaginary_parts():
    """The gradient of irfft with respect to Im X[0] and Im X[n/2] is not
    zero (np.fft.irfft drops them; this package's recombination does not)."""
    n = 16
    xr, xi = _t(_a((2, 9), 0), grad=True), _t(_a((2, 9), 1), grad=True)
    y = F.plan(F.FFTSpec(n, kind="irfft"), device="cpu")((xr, xi))
    _, gi = torch.autograd.grad(y, (xr, xi), _t(_a((2, n), 2)))
    assert gi[:, [0, 8]].abs().max() > 1e-2 * gi.abs().max()


def test_complex_tensor_gradient_is_the_planes_gradient():
    """A complex64 input differentiates as its planes do (torch's conjugate
    Wirtinger gradient of a real loss: ∂L/∂Re + i·∂L/∂Im)."""
    xr, xi = _a((2, 32), 0), _a((2, 32), 1)
    gr, gi = _a((2, 32), 2), _a((2, 32), 3)
    planned = F.plan(F.FFTSpec(32), device="cpu")
    z = torch.complex(_t(xr), _t(xi)).requires_grad_(True)
    y = planned(z)
    (gz,) = torch.autograd.grad((y.real * _t(gr) + y.imag * _t(gi)).sum(), z)
    pr, pi = _t(xr, True), _t(xi, True)
    yr, yi = planned((pr, pi))
    want = torch.autograd.grad((yr, yi), (pr, pi), (_t(gr), _t(gi)))
    assert _rel(gz.real, want[0].numpy()) <= TOL and _rel(gz.imag, want[1].numpy()) <= TOL


def test_backward_runs_the_opposite_direction_plain_passes():
    """A backward runs each leaf's kernels the other way, one plain call per
    pass, and no launch: rfft's backward is irfft's passes, and back."""
    n = 4096
    fwd, inv = (F.plan(F.FFTSpec(n, kind=k), device="cpu") for k in ("rfft", "irfft"))
    x = _t(_a((2, n), 0), grad=True)
    y = fwd(x)
    kernels.reset_counts()
    torch.autograd.grad(y, x, (torch.ones_like(y[0]), torch.ones_like(y[1])))
    counts = kernels.counts()
    want = {f"{k}_plain": inv.kernels.count(k) for k in set(inv.kernels)}
    assert {k: v for k, v in counts.items() if v} == want
    xr = _t(_a((2, n // 2 + 1), 1), grad=True)
    z = inv((xr, torch.zeros_like(xr)))
    kernels.reset_counts()
    torch.autograd.grad(z, xr, torch.ones_like(z))
    assert {k: v for k, v in kernels.counts().items() if v} == {
        f"{k}_plain": fwd.kernels.count(k) for k in set(fwd.kernels)}


def test_without_grad_no_graph_is_built():
    x = _t(_a((2, 64), 0), grad=True)
    with torch.no_grad():
        yr, _ = F.rfft(x)
    assert not yr.requires_grad
    yr, _ = F.rfft(x)
    assert yr.requires_grad and yr.grad_fn is not None


def test_second_order_through_the_leaves():
    """The backward is itself differentiable (``create_graph``): the
    Hessian-vector product of ‖irfft(rfft(x))‖² is 2v."""
    n = 32
    fwd, inv = (F.plan(F.FFTSpec(n, kind=k), device="cpu") for k in ("rfft", "irfft"))
    x = _t(_a((2, n), 0), grad=True)
    v = _t(_a((2, n), 1))
    loss = inv(fwd(x)).square().sum()
    (g,) = torch.autograd.grad(loss, x, create_graph=True)
    (hv,) = torch.autograd.grad(g, x, v)
    assert _rel(hv, 2 * v.numpy()) <= TOL


# ---------------------------------------------------------------------------
# the convolutions and the mixer
# ---------------------------------------------------------------------------


def _grads(port_fn, ref_fn, arrays, cot_shape, seed=9):
    """d(⟨f(x, h), c⟩)/d(x, h) through the port and through ``jax.grad``."""
    cot = _a(cot_shape, seed)
    ref = jax.grad(lambda *a: jnp.sum(ref_fn(*a) * cot), argnums=tuple(range(len(arrays))))(
        *map(jnp.asarray, arrays))
    ts = [_t(a, grad=True) for a in arrays]
    got = torch.autograd.grad((port_fn(*ts) * _t(cot)).sum(), ts)
    return got, ref


@pytest.mark.parametrize("xs,hs,axis,causal", [
    ((3, 40), (9,), -1, True),
    ((2, 37), (2, 11), -1, False),
    ((2, 30, 4), (4, 7), 1, True),
])
def test_fft_conv_gradients_match_reference(xs, hs, axis, causal):
    x, h = _a(xs, 0), _a(hs, 1)
    y_shape = list(xs)
    if not causal:
        y_shape[axis] += hs[-1] - 1
    got, ref = _grads(
        lambda a, b: C.fft_conv(a, b, causal=causal, axis=axis),
        lambda a, b: ref_conv.fft_conv(a, b, causal=causal, axis=axis, backend="xla", tune="off"),
        (x, h), tuple(y_shape))
    for g, r in zip(got, ref):
        assert _rel(g, r) <= TOL


def test_fft_conv_exact_pad_gradients_match_reference():
    x, h = _a((2, 30), 0), _a((7,), 1)
    got, ref = _grads(lambda a, b: C.fft_conv(a, b, pad="exact"),
                      lambda a, b: ref_conv.fft_conv(a, b, pad="exact", backend="xla", tune="off"),
                      (x, h), (2, 30))
    for g, r in zip(got, ref):
        assert _rel(g, r) <= TOL


def test_fft_conv_os_gradients_match_reference():
    x, h = _a((2, 300), 0), _a((17,), 1)
    got, ref = _grads(lambda a, b: overlap.fft_conv_os(a, b, block=64),
                      lambda a, b: ref_overlap.fft_conv_os(a, b, block=64, backend="xla", tune="off"),
                      (x, h), (2, 300))
    for g, r in zip(got, ref):
        assert _rel(g, r) <= TOL


@pytest.mark.parametrize("mode", ["same", "full"])
def test_fft_conv2d_gradients_match_reference(mode):
    x, h = _a((2, 12, 20), 0), _a((3, 5), 1)
    shape = (2, 12, 20) if mode == "same" else (2, 14, 24)
    got, ref = _grads(lambda a, b: C.fft_conv2d(a, b, mode=mode),
                      lambda a, b: ref_conv.fft_conv2d(a, b, mode=mode, backend="xla"), (x, h), shape)
    for g, r in zip(got, ref):
        assert _rel(g, r) <= TOL


@pytest.mark.parametrize("rows", [4, 5])
def test_fft_conv_packed_gradients_match_reference(rows):
    x, h = _a((rows, 40), 0), _a((9,), 1)
    got, ref = _grads(C.fft_conv_packed, lambda a, b: ref_conv.fft_conv_packed(a, b, backend="xla"),
                      (x, h), (rows, 40))
    for g, r in zip(got, ref):
        assert _rel(g, r) <= TOL


@pytest.mark.parametrize("s", [20, 90])
def test_spectral_mixer_gradients_match_reference(s):
    """x, ``filt`` and the three projections; s = 90 > 2·Lf runs the conv
    at n = 128."""
    cfg = ModelConfig(d_model=8, spectral_filter_len=16, compute_dtype="float32")
    params, _ = unzip(ref_spec.spectral_init(jax.random.PRNGKey(0), cfg, jnp.float32))
    params = {k: np.asarray(v) for k, v in params.items()}
    x, cot = _a((2, s, 8), 1), _a((2, s, 8), 2)
    names = sorted(params)

    def ref_loss(p, xx):
        return jnp.sum(ref_spec.spectral_forward(p, xx, cfg=cfg) * cot)

    ref_p, ref_x = jax.grad(ref_loss, argnums=(0, 1))({k: jnp.asarray(v) for k, v in params.items()},
                                                      jnp.asarray(x))
    m = load_reference_params(
        SpectralMixer(8, 16, device="cpu", generator=torch.Generator().manual_seed(0)), params)
    xt = _t(x, grad=True)
    (m(xt) * _t(cot)).sum().backward()
    assert _rel(xt.grad, ref_x) <= TOL
    for name in names:
        assert _rel(getattr(m, name).grad, ref_p[name]) <= TOL, name


def test_mixer_decode_builds_no_graph():
    m = SpectralMixer(8, 16, device="cpu", generator=torch.Generator().manual_seed(0))
    x = _t(_a((2, 20, 8), 0), grad=True)
    out, cache = m(x, return_cache=True)
    assert out.requires_grad
    assert not any(t.requires_grad for t in (cache.hist, cache.chunk, cache.future))
    y, cache = m.stream_decode(x[:, :1], cache)
    assert not y.requires_grad and not cache.future.requires_grad
    ring = SpectralMixer(8, 16, decode_mode="ring", device="cpu")
    _, rc = ring(x, return_cache=True)
    y, rc = ring.decode(x[:, :1], rc)
    assert not y.requires_grad and not rc.buf.requires_grad
