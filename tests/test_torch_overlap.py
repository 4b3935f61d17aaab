"""Overlap-save convolution and StreamingConv (``repro_torch.core.overlap``)
on the CPU route.

Mirrors ``tests/test_overlap.py``: block sizing and framing against the
reference's, ``fft_conv_os`` against the reference (``backend="xla"``,
``tune="off"``) and against the one-shot conv, the plan log's proof that
nothing is planned past ``FUSED_MAX``, StreamingConv's schedules against
one shot, the tuned blocks, and ``spmd=True``'s modelled block.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import overlap as ref_ov
from repro_torch import kernels
from repro_torch.core import conv as C
from repro_torch.core import faults
from repro_torch.core import fft as F
from repro_torch.core import overlap as O
from repro_torch.core import plan as plan_lib
from repro_torch.core import tuning

TOL = 1e-3


def _real(shape, seed=0):
    return np.random.default_rng(seed + 17 + sum(shape)).standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rel(got, ref):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.abs(got.astype(np.float64) - ref).max() / max(np.abs(ref).max(), 1e-30)


def _ref(fn, *arrays, **kw):
    """The reference's ``fn`` under one ``jax.jit``."""
    return np.asarray(jax.jit(functools.partial(fn, **kw))(*map(jnp.asarray, arrays)))


def _new_specs(snapshot):
    return [spec for spec, name in F.plan_log() if (spec, name) not in snapshot]


# ---------------------------------------------------------------------------
# block sizing and framing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lh", [1, 2, 17, 129, 1024, 4097, plan_lib.FUSED_MAX // 2 + 1])
def test_pick_block_is_the_reference_one(lh, monkeypatch):
    assert O.pick_block(lh) == ref_ov.pick_block(lh)
    L = 2**16
    assert O._resolve_block(lh, None, L, 1, "cpu", "off") == O.pick_block(lh)
    # tune=None is the model's pick in both packages.
    monkeypatch.delenv("REPRO_FFT_TUNE", raising=False)
    assert O._resolve_block(lh, None, L, 1, "cpu", None) == ref_ov._resolve_block(lh, None, L, 1, "xla", None)


def test_pick_block_defaults():
    assert O.pick_block(4097) == min(8192 * O.OS_FACTOR, plan_lib.FUSED_MAX)
    assert O.pick_block(129) == 256 * O.OS_FACTOR
    assert O.pick_block(1) == 8
    big = plan_lib.FUSED_MAX // 2 + 1
    assert O.pick_block(big) == 2 * C.next_pow2(big)


@pytest.mark.parametrize("lh,block", [(33, 100), (129, 128), (0, None), (5, 0)])
def test_pick_block_errors(lh, block):
    with pytest.raises(faults.PlanError):
        O.pick_block(lh, block=block)
    with pytest.raises(ValueError):
        ref_ov.pick_block(lh, block=block)


def test_pick_block_override():
    assert O.pick_block(33, block=128) == 128 == ref_ov.pick_block(33, block=128)


def test_frame_signal_windows():
    x = torch.arange(10, dtype=torch.float32)[None]
    f = O.frame_signal(x, block=6, step=4, num_blocks=3)
    assert tuple(f.shape) == (1, 3, 6)
    np.testing.assert_array_equal(f[0, 0], [0, 0, 0, 1, 2, 3])
    np.testing.assert_array_equal(f[0, 1], [2, 3, 4, 5, 6, 7])
    np.testing.assert_array_equal(f[0, 2], [6, 7, 8, 9, 0, 0])


@pytest.mark.parametrize("shape,block,step,nb", [
    ((2, 3, 50), 16, 9, 6), ((37,), 8, 8, 5), ((1, 64), 32, 1, 64), ((2, 5), 4, 3, 4),
])
def test_frame_signal_matches_reference(shape, block, step, nb):
    x = _real(shape)
    ref = np.asarray(ref_ov.frame_signal(jnp.asarray(x), block, step, nb))
    np.testing.assert_array_equal(O.frame_signal(_t(x), block, step, nb).numpy(), ref)


def test_frame_signal_refuses_short_cover():
    x = np.zeros((1, 20), np.float32)
    with pytest.raises(faults.PlanError, match="cover only"):
        O.frame_signal(_t(x), 8, 4, 4)
    with pytest.raises(ValueError, match="cover only"):
        ref_ov.frame_signal(jnp.asarray(x), 8, 4, 4)


# ---------------------------------------------------------------------------
# fft_conv_os
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("xs,hs,block,causal,axis", [
    ((2, 3, 300), (3, 33), 128, True, -1),
    ((1, 200), (1, 17), 64, False, -1),
    ((130, 2), (9,), 32, True, 0),
    ((2, 90, 3), (3, 5), 16, True, 1),
    ((2, 100), (1,), None, True, -1),      # one tap: no overlap
    ((2, 5), (12,), 16, False, -1),        # L < Lh
], ids=str)
def test_fft_conv_os_matches_reference(xs, hs, block, causal, axis):
    x, h = _real(xs), _real(hs, seed=1)
    ref = _ref(ref_ov.fft_conv_os, x, h, causal=causal, axis=axis, block=block,
               backend="xla", tune="off")
    got = O.fft_conv_os(_t(x), _t(h), causal=causal, axis=axis, block=block)
    assert got.is_contiguous()
    assert _rel(got, ref) <= TOL
    one = C.fft_conv(_t(x), _t(h), causal=causal, axis=axis, overlap_save=False)
    assert _rel(got, one.numpy()) <= TOL


def test_fft_conv_os_vs_toeplitz():
    x, h = _real((2, 3, 300)), _real((3, 33), seed=1)
    y = O.fft_conv_os(_t(x), _t(h), block=128)
    assert _rel(y, C.toeplitz_conv_ref(x, h[None])) <= TOL


def test_fft_conv_os_matches_one_shot_long():
    L, Lh = 2**16, 4097
    x, h = _real((2, L)), _real((Lh,), seed=1)
    y_one = C.fft_conv(_t(x), _t(h), overlap_save=False)
    y_os = O.fft_conv_os(_t(x), _t(h))
    assert _rel(y_os, y_one.numpy()) <= TOL


def test_fft_conv_os_dtype_restored():
    x = _t(_real((2, 256))).to(torch.bfloat16)
    h = _t(_real((17,), seed=1)).to(torch.bfloat16)
    assert O.fft_conv_os(x, h, block=64).dtype == torch.bfloat16


def test_fft_conv_os_runs_its_plans_passes():
    """The filter's rfft, one rfft over every frame, one irfft: Σ passes."""
    x, h = _real((2, 300)), _real((33,), seed=1)
    kernels.reset_counts()
    O.fft_conv_os(_t(x), _t(h), block=128)
    want = sum(len(F.plan(F.FFTSpec(128, kind=k), device="cpu").passes) * c
               for k, c in (("rfft", 2), ("irfft", 1)))
    assert sum(v for k, v in kernels.counts().items() if k.endswith("_plain")) == want


def test_fft_conv_os_empty_batch_runs_nothing():
    x, h = np.zeros((0, 3, 300), np.float32), _real((3, 33), seed=1)
    ref = _ref(ref_ov.fft_conv_os, x, h, block=128, backend="xla", tune="off")
    kernels.reset_counts()
    y = O.fft_conv_os(_t(x), _t(h), block=128)
    assert tuple(y.shape) == ref.shape
    assert sum(kernels.counts().values()) == 0


# ---------------------------------------------------------------------------
# plan-cache discipline
# ---------------------------------------------------------------------------


def test_fft_conv_auto_routes_long_signals():
    L, Lh = 2**16, 129  # next_pow2(L + Lh - 1) = 2**17 > FUSED_MAX
    x, h = _real((1, L)), _real((Lh,), seed=1)
    snapshot = set(F.plan_log())
    y_auto = C.fft_conv(_t(x), _t(h))
    new = _new_specs(snapshot)
    assert all(max(s.n, s.n2 or 0) <= plan_lib.FUSED_MAX for s in new), new
    # Routed: the very computation of fft_conv_os at the heuristic block.
    np.testing.assert_array_equal(y_auto.numpy(), O.fft_conv_os(_t(x), _t(h)).numpy())
    y_one = C.fft_conv(_t(x), _t(h), overlap_save=False)
    assert _rel(y_auto, y_one.numpy()) <= TOL
    ref = _ref(ref_ov.fft_conv_os, x, h, backend="xla", tune="off")
    assert _rel(y_auto, ref) <= TOL


def test_fft_conv_short_signals_stay_one_shot():
    x, h = _real((2, 1024)), _real((64,), seed=1)
    F.clear_plan_log()
    C.fft_conv(_t(x), _t(h))
    C.fft_conv(_t(x), _t(h))
    specs = [s for s, _ in F.plan_log()]
    assert all(s.n <= plan_lib.FUSED_MAX for s in specs)
    # Planned once: a warm call adds nothing to the log.
    assert len(specs) == len(set(specs))


def test_plan_log_records_misses_only():
    F.clear_plan_log()
    spec = F.FFTSpec(96, kind="rfft")
    F.plan(spec, device="cpu")
    logged = F.plan_log()
    assert logged and logged[-1] == (spec, "torch")
    F.plan(spec, device="cpu")
    assert F.plan_log() == logged
    F.clear_plan_log()
    assert F.plan_log() == ()
    assert F.plan(spec, device="cpu") is F.plan(spec, device="cpu")  # the cache stays


# ---------------------------------------------------------------------------
# StreamingConv: chunked == one-shot
# ---------------------------------------------------------------------------


def _stream(sc, x, schedule):
    state = sc.init_state(x.shape[:-1])
    outs, pos = [], 0
    for c in schedule:
        y, state = sc(_t(x[..., pos:pos + c]), state)
        outs.append(y.numpy())
        pos += c
    assert pos == x.shape[-1]
    return np.concatenate(outs, axis=-1), state


def _ref_stream(sc, x, schedule):
    state = sc.init_state(x.shape[:-1])
    step = jax.jit(lambda xc, st: sc(xc, st))
    outs, pos = [], 0
    for c in schedule:
        y, state = step(jnp.asarray(x[..., pos:pos + c]), state)
        outs.append(np.asarray(y))
        pos += c
    return np.concatenate(outs, axis=-1)


@pytest.mark.parametrize("schedule", [
    [640] * 7 + [520],          # ragged final chunk
    [64] * 78 + [8],            # every chunk smaller than Lh
    [1000, 17, 3000, 983],      # mixed, including chunk << Lh
], ids=["ragged", "short", "mixed"])
def test_streaming_matches_one_shot(schedule):
    L, Lh = sum(schedule), 129
    x, h = _real((2, L)), _real((Lh,), seed=1)
    sc = O.StreamingConv(_t(h), tune="off")
    assert sc.block == ref_ov.StreamingConv(jnp.asarray(h), tune="off").block
    y_stream, state = _stream(sc, x, schedule)
    assert tuple(state.shape) == (2, Lh - 1)
    np.testing.assert_array_equal(state.numpy(), x[:, -(Lh - 1):])
    y_one = O.fft_conv_os(_t(x), _t(h))
    assert _rel(y_stream, y_one.numpy()) <= TOL


def test_streaming_matches_reference_stream():
    schedule = [300, 7, 500, 193]
    x, h = _real((2, sum(schedule))), _real((65,), seed=1)
    sc = O.StreamingConv(_t(h), block=256)
    y, _ = _stream(sc, x, schedule)
    ref = _ref_stream(ref_ov.StreamingConv(jnp.asarray(h), block=256, backend="xla"), x, schedule)
    assert _rel(y, ref) <= TOL


def test_streaming_warm_chunks_plan_nothing():
    x, h = _real((2, 2048)), _real((33,), seed=1)
    sc = O.StreamingConv(_t(h), block=128)
    _stream(sc, x, [1024, 1024])  # warm: the block plans exist
    F.clear_plan_log()
    _stream(sc, x, [512, 50, 462, 1024])
    assert F.plan_log() == (), F.plan_log()


def test_streaming_per_channel_filters():
    x, h = _real((2, 3, 500)), _real((3, 33), seed=1)
    sc = O.StreamingConv(_t(h), block=128)
    y_stream, _ = _stream(sc, x, [200, 300])
    assert _rel(y_stream, C.toeplitz_conv_ref(x, h[None])) <= TOL


def test_streaming_one_tap_filter():
    x = _real((2, 100))
    sc = O.StreamingConv(_t(np.array([2.0], np.float32)))
    y, state = _stream(sc, x, [60, 40])
    assert tuple(state.shape) == (2, 0)
    np.testing.assert_allclose(y, 2.0 * x, atol=1e-5)


def test_streaming_rejects_bad_state():
    sc = O.StreamingConv(_t(_real((17,))))
    with pytest.raises(faults.PlanError, match="state carries"):
        sc(torch.zeros(2, 8), torch.zeros(2, 3))
    with pytest.raises(faults.PlanError, match="state carries"):
        sc.lookahead(torch.zeros(2, 3), 4)


def test_streaming_lookahead_matches_reference():
    h, tail = _real((33,), seed=1), _real((2, 32))
    sc = O.StreamingConv(_t(h), block=64)
    ref = ref_ov.StreamingConv(jnp.asarray(h), block=64, backend="xla")
    for window in (1, 16, 40):
        got = sc.lookahead(_t(tail), window)
        assert _rel(got, np.asarray(ref.lookahead(jnp.asarray(tail), window))) <= TOL


def test_streaming_empty_batch_runs_nothing():
    sc = O.StreamingConv(_t(_real((17,))), block=64)
    kernels.reset_counts()
    y, state = sc(torch.zeros(0, 100), sc.init_state((0,)))
    assert tuple(y.shape) == (0, 100) and tuple(state.shape) == (0, 16)
    assert sum(kernels.counts().values()) == 0


# ---------------------------------------------------------------------------
# tuned blocks, and spmd=True's modelled block
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tune", ["model", "measure"])
def test_tuning_modes_raise(tune, tmp_path, monkeypatch):
    # Once a refusal, now the tuned result: the block is the tuner's pick
    # (model: the reference's own; measure: timed on the CPU), the output
    # the heuristic block's at tolerance.
    from repro.core import tuning as ref_tuning

    monkeypatch.setenv("REPRO_TUNING_CACHE", str(tmp_path / "tuning.json"))
    tuning.cache.clear()
    x, h = _t(_real((1, 2**16))), _t(_real((129,), seed=1))
    blk = tuning.tuned_block(2**16, 129, 1, "cpu", tune)
    if tune == "model":
        assert blk == ref_tuning.tuned_block(2**16, 129, 1, "xla", "model")
    off = O.fft_conv_os(x, h, tune="off")
    assert _rel(O.fft_conv_os(x, h, tune=tune), off.numpy()) <= TOL
    assert _rel(C.fft_conv(x, h, tune=tune), off.numpy()) <= TOL  # auto-routed to overlap-save
    assert O.StreamingConv(h, tune=tune).block == tuning.tuned_block(
        8 * O.pick_block(129), 129, 1, "cpu", tune)
    # An explicit block needs no tuner, as in the reference.
    assert O.StreamingConv(h, tune=tune, block=512).block == 512
    tuning.cache.clear()


def test_unknown_tune_and_spmd_raise():
    h = _t(_real((17,)))
    with pytest.raises(faults.PlanError, match="tune must be"):
        O.StreamingConv(h, tune="fast")
    # spmd=True takes the modelled block (no cache, no measurement), the
    # reference's rule; an explicit block still wins.
    before = len(tuning.measure_log())
    sc = O.StreamingConv(h, spmd=True, tune="measure")
    assert sc.block == tuning.modeled_block(8 * O.pick_block(17), 17, 1, "cpu")
    assert sc.block == ref_ov.StreamingConv(jnp.asarray(h.numpy()), spmd=True).block
    assert len(tuning.measure_log()) == before
    assert O.StreamingConv(h, spmd=True, block=256).block == 256
