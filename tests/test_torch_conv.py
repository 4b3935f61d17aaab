"""The convolution layer (``repro_torch.core.conv``) on the CPU route.

Mirrors ``tests/test_fft_conv.py``: the same seeded numpy inputs go through
the reference's convolutions (``backend="xla"``) and the port's (CPU
tensors, so every kernel runs its plain version), held at 1e-3·max|ref|;
beside them the direct numpy oracles, the dtype rule, the degenerate
lengths and the empty batch.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import conv as ref_conv
from repro_torch import kernels
from repro_torch.core import conv as C
from repro_torch.core import faults
from repro_torch.core import fft as F
from repro_torch.core import limits

TOL = 1e-3


def _rng(*key):
    return np.random.default_rng(sum(key) + 11)


def _real(shape, seed=0):
    return _rng(seed, *shape).standard_normal(shape).astype(np.float32)


def _rel(got, ref):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.abs(got.astype(np.float64) - ref).max() / max(np.abs(ref).max(), 1e-30)


def _ref(fn, *arrays, **kw):
    """The reference's ``fn`` under one ``jax.jit`` (one compile per call,
    not one per eager op)."""
    return np.asarray(jax.jit(functools.partial(fn, **kw))(*map(jnp.asarray, arrays)))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _plain_calls():
    return sum(v for k, v in kernels.counts().items() if k.endswith("_plain"))


def _launches(*specs_and_calls):
    """Σ len(plan.passes) over (spec, calls) pairs: what a conv must run."""
    return sum(len(F.plan(spec, device="cpu").passes) * calls for spec, calls in specs_and_calls)


def test_next_pow2_is_the_limits_one():
    assert C.next_pow2 is limits.next_pow2
    for n in (1, 5, 1024, 1025, 3000):
        assert C.next_pow2(n) == ref_conv.next_pow2(n)


# (x shape, h shape, axis, causal, pad)
CASES = [
    ((2, 4, 128), (4, 32), -1, True, "pow2"),   # per-channel filters
    ((3, 4, 96), (4, 24), -1, True, "pow2"),
    ((1, 64), (1, 16), -1, False, "pow2"),      # full mode
    ((2, 40, 6), (6, 9), 1, True, "pow2"),      # (B, S, D) along the sequence
    ((5, 3), (3,), 0, False, "pow2"),           # axis 0, full
    ((2, 100), (1,), -1, True, "pow2"),         # Lh = 1
    ((2, 7), (20,), -1, True, "pow2"),          # L < Lh
    ((2, 7), (20,), -1, False, "pow2"),
    ((3, 1), (5,), -1, True, "pow2"),           # L = 1
    ((2, 3, 60), (3, 15), -1, True, "exact"),   # n = 74: Bluestein child + recomb
    ((2, 60), (16,), -1, False, "exact"),       # n = 75: odd, one complex child
    ((1, 500), (128,), -1, True, "pow2"),
    ((1, 256), (33,), -1, True, "exact"),       # n = 288
]


@pytest.mark.parametrize("xs,hs,axis,causal,pad", CASES, ids=str)
def test_fft_conv_matches_reference(xs, hs, axis, causal, pad):
    x, h = _real(xs), _real(hs, seed=1)
    ref = _ref(ref_conv.fft_conv, x, h, causal=causal, axis=axis, backend="xla", tune="off",
               pad=pad)
    got = C.fft_conv(_t(x), _t(h), causal=causal, axis=axis, pad=pad)
    assert got.dtype == torch.float32 and got.is_contiguous()
    assert _rel(got, ref) <= TOL


def test_fft_conv_per_channel_filters_vs_toeplitz():
    x, h = _real((3, 4, 96)), _real((4, 24), seed=1)
    y = C.fft_conv(_t(x), _t(h))
    assert _rel(y, C.toeplitz_conv_ref(x, h[None])) <= TOL


def test_toeplitz_oracle_is_the_reference_one():
    x, h = _real((2, 3, 50)), _real((3, 7), seed=2)
    np.testing.assert_array_equal(C.toeplitz_conv_ref(x, h), ref_conv.toeplitz_conv_ref(x, h))


def test_fft_conv_runs_its_plans_passes():
    """One-shot: the rfft plan twice (signal, filter) and the irfft plan once,
    one plain call per pass and nothing else."""
    x, h = _real((2, 4, 100)), _real((4, 29), seed=1)
    kernels.reset_counts()
    C.fft_conv(_t(x), _t(h))
    n = C.next_pow2(128)
    want = _launches((F.FFTSpec(n, kind="rfft"), 2), (F.FFTSpec(n, kind="irfft"), 1))
    assert _plain_calls() == want
    assert all(v == 0 for k, v in kernels.counts().items() if not k.endswith("_plain"))


def test_fft_conv_one_tap_one_sample_raises_as_the_reference():
    x, h = np.ones((1, 1), np.float32), np.ones((1,), np.float32)
    with pytest.raises(ValueError):
        ref_conv.fft_conv(jnp.asarray(x), jnp.asarray(h), backend="xla", tune="off")
    with pytest.raises(faults.PlanError, match="rfft length"):
        C.fft_conv(_t(x), _t(h))


def test_fft_conv_bad_pad_raises():
    with pytest.raises(ValueError, match="pad"):
        C.fft_conv(torch.zeros(1, 8), torch.ones(2), pad="pow3")


def test_fft_conv_bf16_in_f32_accurate_out():
    x32, h32 = _real((2, 3, 128)), _real((3, 32), seed=1)
    x, h = _t(x32).to(torch.bfloat16), _t(h32).to(torch.bfloat16)
    y = C.fft_conv(x, h)
    assert y.dtype == torch.bfloat16
    ref = C.toeplitz_conv_ref(x.float().numpy(), h.float().numpy()[None])
    # one bf16 rounding of a float32-accurate result: ~2^-8 relative
    assert _rel(y.float(), ref) <= 0.02
    ref_y = ref_conv.fft_conv(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                              jnp.asarray(h.float().numpy(), jnp.bfloat16), backend="xla")
    assert _rel(y.float(), np.asarray(ref_y, np.float32)) <= 0.02


@pytest.mark.parametrize("rows", [3, 5])
def test_fft_conv_packed_odd_rows(rows):
    x, h = _real((2, rows, 100)), _real((16,), seed=1)
    y = C.fft_conv_packed(_t(x), _t(h))
    assert y.shape == x.shape
    ref = _ref(ref_conv.fft_conv_packed, x, h, backend="xla")
    assert _rel(y, ref) <= TOL
    assert _rel(y, C.toeplitz_conv_ref(x, h)) <= TOL


@pytest.mark.parametrize("rows", [3, 4])
def test_fft_conv_packed_full_mode(rows):
    x, h = _real((rows, 60)), _real((9,), seed=1)
    y = C.fft_conv_packed(_t(x), _t(h), causal=False)
    assert y.shape == (rows, 68)
    ref = _ref(ref_conv.fft_conv_packed, x, h, causal=False, backend="xla")
    assert _rel(y, ref) <= TOL
    assert _rel(y, np.stack([np.convolve(r, h, mode="full") for r in x])) <= TOL


def test_fft_conv_packed_runs_its_plans_passes():
    x, h = _real((4, 50)), _real((15,), seed=1)
    kernels.reset_counts()
    C.fft_conv_packed(_t(x), _t(h))
    want = _launches((F.FFTSpec(64), 1), (F.FFTSpec(64, kind="ifft"), 1), (F.FFTSpec(64, kind="rfft"), 1))
    assert _plain_calls() == want


@pytest.mark.parametrize("mode", ["same", "full"])
@pytest.mark.parametrize("xs,hs", [((2, 16, 32), (3, 5)), ((24, 40), (1, 9)), ((1, 9, 7), (4, 4))], ids=str)
def test_fft_conv2d_matches_reference(xs, hs, mode):
    x, h = _real(xs), _real(hs, seed=1)
    ref = _ref(ref_conv.fft_conv2d, x, h, mode=mode, backend="xla")
    got = C.fft_conv2d(_t(x), _t(h), mode=mode)
    assert _rel(got, ref) <= TOL


def test_fft_conv2d_per_row_matched_filter_is_row_conv():
    """A (1, Wh) filter convolves each row alone (SAR range compression)."""
    x, h = _real((6, 50)), _real((1, 11), seed=1)
    y = C.fft_conv2d(_t(x), _t(h), mode="same")
    assert _rel(y, C.toeplitz_conv_ref(x, h[0])) <= TOL


def test_fft_conv2d_bad_mode_raises():
    with pytest.raises(ValueError, match="mode"):
        C.fft_conv2d(torch.zeros(4, 4), torch.ones(1, 2), mode="valid")


def test_fft_conv_packed_and_2d_restore_dtype():
    xb = _t(_real((2, 4, 64))).to(torch.bfloat16)
    hb = _t(_real((16,), seed=1)).to(torch.bfloat16)
    assert C.fft_conv_packed(xb, hb).dtype == torch.bfloat16
    img = _t(_real((16, 32))).to(torch.bfloat16)
    k = _t(_real((3, 5), seed=1)).to(torch.bfloat16)
    assert C.fft_conv2d(img, k).dtype == torch.bfloat16
    assert C.fft_conv2d(_t(_real((16, 32))), _t(_real((3, 5)))).dtype == torch.float32


@pytest.mark.parametrize(
    "fn,xs,hs,kw",
    [
        (C.fft_conv, (0, 4, 50), (4, 9), {}),
        (C.fft_conv, (0, 50), (9,), {"causal": False}),
        (C.fft_conv, (0, 30, 4), (4, 9), {"axis": 1}),
        (C.fft_conv, (0, 50), (9,), {"pad": "exact"}),
        (C.fft_conv_packed, (0, 3, 50), (9,), {}),
        (C.fft_conv2d, (0, 8, 16), (3, 3), {"mode": "full"}),
    ],
    ids=["conv", "full", "axis", "exact", "packed", "2d"],
)
def test_empty_batch_runs_nothing(fn, xs, hs, kw):
    """A batch of 0: the reference's output shape, and not one pass run (the
    filter's transform included)."""
    x, h = np.zeros(xs, np.float32), _real(hs, seed=1)
    ref_fn = getattr(ref_conv, fn.__name__)
    ref = _ref(ref_fn, x, h, backend="xla", **kw)
    kernels.reset_counts()
    y = fn(_t(x), _t(h), **kw)
    assert tuple(y.shape) == tuple(ref.shape)
    assert sum(kernels.counts().values()) == 0


def test_host_arrays_go_to_the_card(monkeypatch):
    """A numpy input means the card, as ``fft.fft`` does: without one the
    call raises instead of picking the CPU; a CPU tensor runs where it is."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, h = _real((2, 64)), _real((8,), seed=1)
    with pytest.raises(faults.PlanError, match="no CUDA device"):
        C.fft_conv(x, h)
    with pytest.raises(faults.PlanError, match="no CUDA device"):
        C.fft_conv2d(x, h[None])
    assert C.fft_conv(x, h, device="cpu").device.type == "cpu"
    assert C.fft_conv(_t(x), h).device.type == "cpu"
    with pytest.raises(faults.PlanError, match="runs on"):
        C.fft_conv(_t(x), h, device="meta")
