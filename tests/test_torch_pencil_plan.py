"""The distributed pencil FFT's plan layer on one process, against the
reference (``repro.core.distributed`` and friends).

Mirrors ``tests/test_pencil_plan.py``: the factorization, the on-device
twiddle window, the pencil roofline report, the tuner's pencil space and
its modelled-only picks, ``plan_pencil``'s cache and schedule text, the
one-rank collapse (no process group: no collective), the 2-D plan's row
and column halves, and ``StreamingConv(spmd=True)``.  The four-rank
schedule runs in ``tests/test_torch_distributed.py``.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import roofline as ref_rl
from repro.core import distributed as ref_D
from repro.core import fft as ref_fft
from repro.core import overlap as ref_ov
from repro.core import tuning as ref_tuning
from repro.core import twiddle as ref_tw
from repro_torch.analysis import roofline as rl
from repro_torch.core import distributed as D
from repro_torch.core import faults, tuning
from repro_torch.core import fft as F
from repro_torch.core import overlap as O
from repro_torch.core import twiddle as tw

TOL = 1e-5  # the port vs the reference, relative to max|ref|
NP_TOL = 5e-5  # vs np.fft in complex128, the reference's distributed tolerance


def _c(planes):
    return planes[0].numpy().astype(np.float64) + 1j * planes[1].numpy()


def _ref_c(planes):
    return np.asarray(planes[0]).astype(np.float64) + 1j * np.asarray(planes[1])


def _rel(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


def _complex(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _planes(x):
    return torch.from_numpy(x.real.copy()), torch.from_numpy(x.imag.copy())


def _ulps(a, b) -> int:
    """Largest distance in float32 units in the last place."""
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int(np.abs(ia - ib).max())


# ---------------------------------------------------------------------------
# pencil_factors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [1, 2, 4, 8, 16])
def test_pencil_factors_are_the_reference_ones(d):
    for lg in range(4, 41):
        n = 1 << lg
        try:
            want = ref_D.pencil_factors(n, d)
        except Exception as err:  # the reference's refusal, message and all
            with pytest.raises(faults.PlanError) as got:
                D.pencil_factors(n, d)
            assert str(got.value) == str(err)
            continue
        assert D.pencil_factors(n, d) == want, (n, d)


def test_pencil_factors_refuse_non_powers_of_two():
    with pytest.raises(faults.PlanError):
        D.pencil_factors(3000, 4)


# ---------------------------------------------------------------------------
# the twiddle window
# ---------------------------------------------------------------------------


def _ref_angles(n1, n2, col_start, q):
    """The reference's float32 angles (``traced_twiddle``'s expression)."""
    n = n1 * n2
    k1 = jnp.arange(n1, dtype=jnp.int32)[:, None]
    m2 = (col_start + jnp.arange(q, dtype=jnp.int32))[None, :]
    if n < 2**31:
        return np.asarray(np.float32(2.0 * np.pi / n) * ((k1 * m2) % n).astype(jnp.float32))
    return np.asarray(np.float32(2.0 * np.pi) * ref_tw.mulfrac_pow2(k1, m2, n))


@pytest.mark.parametrize("n1,n2,windows", [
    (16, 32, [(0, None), (8, 8), (24, 8)]),
    (1024, 1024, [(0, None), (256, 256), (768, 128)]),
    (4096, 2048, [(0, 512), (1536, 512)]),
])
@pytest.mark.parametrize("inverse", [False, True])
def test_twiddle_window_is_traced_twiddle(n1, n2, windows, inverse):
    for start, count in windows:
        q = n2 if count is None else count
        ang = tw.window_angles(n1, n2, col_start=start, col_count=count)
        assert ang.dtype == torch.float32 and ang.shape == (n1, q)
        assert np.array_equal(ang.numpy(), _ref_angles(n1, n2, start, q))  # bit for bit
        got = tw.twiddle_window(n1, n2, inverse, col_start=start, col_count=count)
        want = ref_tw.traced_twiddle(n1, n2, inverse, col_start=start, col_count=count)
        for g, w in zip(got, want):
            # XLA's float32 cos/sin and torch's round differently: one ulp.
            assert _ulps(g.numpy(), np.asarray(w)) <= 1


@pytest.mark.parametrize("n1,n2,start", [(1 << 16, 1 << 16, (1 << 16) - 64), (1 << 17, 1 << 17, 12345)])
def test_twiddle_window_past_2_31(n1, n2, start):
    n = n1 * n2  # 2^32, 2^34
    k1 = torch.arange(n1 - 8, n1, dtype=torch.int64)[:, None]
    m2 = (start + torch.arange(64, dtype=torch.int64))[None, :]
    got = tw.mulfrac_pow2(k1, m2, n)
    want = ref_tw.mulfrac_pow2(jnp.asarray(k1.numpy(), jnp.int32), jnp.asarray(m2.numpy(), jnp.int32), n)
    assert np.array_equal(got.numpy(), np.asarray(want))  # bit for bit
    # A small window of the grid against the reference's, rows included.
    ang = tw.window_angles(n1, n2, col_start=start, col_count=64)
    assert np.array_equal(ang.numpy(), _ref_angles(n1, n2, start, 64))
    wr, wi = tw.twiddle_window(n1, n2, col_start=start, col_count=64)
    rr, ri = ref_tw.traced_twiddle(n1, n2, col_start=start, col_count=64)
    assert _ulps(wr.numpy(), np.asarray(rr)) <= 1 and _ulps(wi.numpy(), np.asarray(ri)) <= 1
    with pytest.raises(ValueError):
        tw.mulfrac_pow2(k1, m2, 3 << 20)


# ---------------------------------------------------------------------------
# the roofline report and the tuner's space
# ---------------------------------------------------------------------------

_COUNT_KEYS = ("n1", "n2", "pack", "chunks", "natural_order", "a2a_steps", "a2a_calls",
               "comm_bytes_per_step", "comm_bytes_total", "fft1_bytes", "fft2_bytes", "twiddle_bytes",
               "local_hbm_bytes")


@pytest.mark.parametrize("n,d", [(4096, 1), (8192, 8), (65536, 4), (1 << 20, 4), (1 << 24, 16)])
def test_pencil_report_bytes_are_the_reference_ones(n, d):
    for pack in (True, False):
        for k in (1, 2, 4):
            for natural in (True, False):
                got = rl.pencil_report(n, d, 2, pack=pack, chunks=k, natural_order=natural)
                want = ref_rl.pencil_report(n, d, 2, pack=pack, chunks=k, natural_order=natural)
                assert {key: got[key] for key in _COUNT_KEYS} == {key: want[key] for key in _COUNT_KEYS}
                # Seconds at the H100's rates: the reference's formulas.
                hw = rl.H100
                serial = (got["a2a_steps"] * got["comm_bytes_per_step"] / hw.link_bw
                          + got["local_hbm_bytes"] / hw.hbm_bw + 2 * got["a2a_steps"] * rl.COLLECTIVE_LAUNCH_S)
                assert got["serial_s"] == pytest.approx(serial, rel=1e-12)
                assert got["memory_s"] == pytest.approx(got["local_hbm_bytes"] / hw.hbm_bw, rel=1e-12)


def test_h100_link_rate_is_one_direction():
    assert rl.H100.link_bw == 450e9
    assert rl.COLLECTIVE_LAUNCH_S == ref_rl.COLLECTIVE_LAUNCH_S


@pytest.mark.parametrize("n,d", [(8192, 8), (65536, 16), (1 << 20, 4), (1 << 24, 4)])
@pytest.mark.parametrize("natural", [True, False])
def test_for_pencil_candidates_are_the_reference_ones(n, d, natural):
    got = tuning.TuningSpace.for_pencil(n, d, 1, natural_order=natural)
    want = ref_tuning.TuningSpace.for_pencil(n, d, 1, natural_order=natural)
    assert got.measure_fn is None
    assert [c[0] for c in got.candidates] == [c[0] for c in want.candidates]
    assert all(cost > 0 and 0 < work <= 132 * 1024 for _cfg, cost, work in got.candidates)


def test_pencil_config_off_and_model(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_TUNING_CACHE", str(tmp_path / "tuning.json"))
    before = len(tuning.measure_log())
    for n, d in ((8192, 8), (65536, 4), (1 << 20, 4), (1 << 24, 4)):
        for natural in (True, False):
            off = tuning.pencil_config(n, d, tune="off", natural_order=natural)
            assert off == ref_tuning.pencil_config(n, d, tune="off", natural_order=natural)
            assert (off["n1"], off["n2"]) == D.pencil_factors(n, d) and off["pack"] and off["a2a_chunks"] == 1
            model = tuning.pencil_config(n, d, tune="model", natural_order=natural)
            assert tuning.pencil_config(n, d, tune="model", natural_order=natural) == model
            assert tuning.pencil_config(n, d, tune="measure", natural_order=natural) == model
            assert model["n1"] * model["n2"] == n and model["n1"] % d == 0 and model["n2"] % d == 0
    assert tuning.pencil_config(4096, 1) == {"n1": 64, "n2": 64, "pack": True, "a2a_chunks": 1}
    assert len(tuning.measure_log()) == before
    assert not os.path.exists(tuning.cache_path())


#: ``"model"`` picks (n1, n2, K; all packed) at fftbench's pod sizes, batch
#: 1: the port's at the H100's rates (NVLink one way, 450 GB/s; HBM
#: 3.35 TB/s) beside the reference's at a TPU v5e's (50 GB/s, 819 GB/s).
MODEL_PICKS = {
    (1 << 20, 4, True): ((128, 8192, 1), (128, 8192, 1)),
    (1 << 20, 4, False): ((8192, 128, 1), (128, 8192, 1)),
    (1 << 20, 8, True): ((128, 8192, 1), (128, 8192, 1)),
    (1 << 24, 4, True): ((4096, 4096, 2), (8192, 2048, 4)),
    (1 << 24, 4, False): ((4096, 4096, 2), (8192, 2048, 4)),
    (1 << 24, 8, True): ((4096, 4096, 1), (4096, 4096, 2)),
    (1 << 26, 4, True): ((16384, 4096, 4), (16384, 4096, 8)),
}


@pytest.mark.parametrize("key", sorted(MODEL_PICKS))
def test_model_picks_beside_the_reference(key):
    n, d, natural = key
    ours, theirs = MODEL_PICKS[key]
    for cfg, want in ((tuning.pencil_config(n, d, natural_order=natural, tune="model"), ours),
                      (ref_tuning.pencil_config(n, d, natural_order=natural, tune="model"), theirs)):
        assert (cfg["n1"], cfg["n2"], cfg["a2a_chunks"]) == want and cfg["pack"]


# ---------------------------------------------------------------------------
# PencilPlan / plan_pencil
# ---------------------------------------------------------------------------


def test_plan_pencil_resolves_and_caches():
    pl = D.plan_pencil(8192, 8, device="cpu")
    assert (pl.n1, pl.n2) in [tuple(c[0][k] for k in ("n1", "n2"))
                              for c in tuning.TuningSpace.for_pencil(8192, 8).candidates]
    assert pl.p == pl.n1 // 8 and pl.q == pl.n2 // 8
    assert D.plan_pencil(8192, 8, device="cpu") is pl
    assert D.plan_pencil(8192, 8, device="cpu", inverse=True) is not pl
    assert pl.plan_n1.spec == F.FFTSpec(n=pl.n1, axis=-2) and pl.plan_n2.spec == F.FFTSpec(n=pl.n2)
    assert pl.local_plan is None and D.plan_pencil(4096, 1, device="cpu").local_plan.spec.n == 4096


def test_a2a_count_math():
    def plan(**kw):
        return D.plan_pencil(8192, 8, device="cpu", **kw)

    assert plan(chunks=1).a2a_count(True) == 3
    assert plan(chunks=1).a2a_count(False) == 2
    assert plan(chunks=2).a2a_count(True) == 5
    assert plan(pack=False).a2a_count(True) == 6
    assert plan(pack=False).a2a_count(False) == 4
    assert D.plan_pencil(4096, 1, device="cpu").a2a_count(True) == 0
    assert D.plan_pencil(4096, 1, device="cpu").a2a_count(False) == 0
    for kw in ({}, {"chunks": 2}, {"pack": False}):
        assert plan(**kw).a2a_count(True) == ref_D.plan_pencil(8192, 8, **kw).a2a_count(True)


def test_chunk_count_clamps_to_divide_columns():
    pl = D.plan_pencil(8192, 8, device="cpu")
    assert D.plan_pencil(8192, 8, device="cpu", chunks=4 * pl.q).a2a_chunks == pl.q
    odd = D.plan_pencil(8192, 8, device="cpu", chunks=3)
    assert odd.q % odd.a2a_chunks == 0
    assert D.plan_pencil(8192, 8, device="cpu", pack=False, chunks=4).a2a_chunks == 1


def test_plan_pencil_rejects_bad_factors():
    with pytest.raises(faults.PlanError, match="!= n=8192"):
        D.plan_pencil(8192, 8, device="cpu", factors=(64, 64))
    with pytest.raises(faults.PlanError, match="not divisible by d=8"):
        D.plan_pencil(8192, 8, device="cpu", factors=(2048, 4))


def test_describe_prints_schedule():
    pl = D.plan_pencil(8192, 8, device="cpu", chunks=2)
    s = pl.describe()
    assert f"factors {pl.n1}x{pl.n2} (p={pl.p}, q={pl.q})" in s
    assert "packed a2a x5 natural / x4 pencil (K=2)" in s and "MB/step" in s
    assert "leaf n1:" in s and "leaf n2:" in s
    s1 = D.plan_pencil(4096, 1, device="cpu").describe()
    assert "0 collectives" in s1 and "local:" in s1
    assert "split-plane a2a x6 natural / x4 pencil" in D.plan_pencil(8192, 8, device="cpu", pack=False).describe()
    assert repr(pl).startswith(f"PencilPlan(n=8192, d=8, {pl.n1}x{pl.n2}, pack=True, K=2")


# ---------------------------------------------------------------------------
# one rank: the collapse
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [4096, 1 << 16])
def test_single_rank_collapses(n):
    x = _complex((2, n), 11)
    ref = np.fft.fft(x.astype(np.complex128))
    D.reset_counts()
    y = D.pfft(*_planes(x))
    assert _rel(_c(y), ref) < NP_TOL
    assert _rel(_c(D.pifft(*y)), x.astype(np.complex128)) < NP_TOL
    # Pencil layout: [k1, k2] holds X[k1 + n1·k2], as the reference's d = 1
    # branch (which never reads its axis, so it runs outside shard_map).
    p = D.pfft(*_planes(x), natural_order=False)
    want = ref_D.pfft(jnp.asarray(x.real), jnp.asarray(x.imag), n=n, axis_name="x", num_shards=1,
                      natural_order=False, backend="xla")
    assert _rel(_c(p), _ref_c(want)) < TOL
    n1, n2 = D.pencil_factors(n, 1)
    assert _rel(_c(p).reshape(2, n1, n2), ref.reshape(2, n2, n1).transpose(0, 2, 1)) < NP_TOL
    back = D.pifft(*p, from_pencil=True)
    want = ref_D.pifft(*want, n=n, axis_name="x", num_shards=1, from_pencil=True, backend="xla")
    assert _rel(_c(back), _ref_c(want)) < TOL
    assert _rel(_c(back), x.astype(np.complex128)) < NP_TOL
    assert D.counts() == {"all_to_all": 0, "all_gather": 0}


def test_single_rank_pfft2d_and_conv():
    img = _complex((2, 64, 128), 12)
    D.reset_counts()
    y = D.pfft2d(*_planes(img), n1=64, n2=128)
    assert _rel(_c(y), np.fft.fft2(img.astype(np.complex128))) < NP_TOL
    rng = np.random.default_rng(13)
    x, h = rng.standard_normal((2, 5000)).astype(np.float32), rng.standard_normal(65).astype(np.float32)
    got = D.pconv_os_sharded(torch.from_numpy(x), torch.from_numpy(h), block=256)
    ref = np.stack([np.convolve(r.astype(np.float64), h)[:5000] for r in x])
    assert _rel(got.numpy().astype(np.float64), ref) < 1e-4
    assert D.counts() == {"all_to_all": 0, "all_gather": 0}
    with pytest.raises(faults.PlanError, match="pfft2d over 1 ranks"):
        D.pfft2d(*_planes(img), n1=32, n2=128)
    with pytest.raises(faults.PlanError, match="is not n=100"):
        D.pfft(*_planes(_complex((1, 64), 1)), n=100)


# ---------------------------------------------------------------------------
# the 2-D plan's halves
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["fft2", "ifft2"])
@pytest.mark.parametrize("n2,n,d", [(64, 128, 4), (128, 256, 8), (32, 3000, 2)])
def test_apply_rows_and_cols_are_the_reference_halves(kind, n2, n, d):
    img = _complex((2, n2, n), 21)
    spec = F.FFTSpec(n=n, kind=kind, n2=n2)
    ours = F.plan(spec, device="cpu")
    ref = ref_fft.plan(ref_fft.FFTSpec(n=n, kind=kind, n2=n2), backend="xla")
    rows = ours.apply_rows(*_planes(img))
    want_rows = ref.apply_rows(jnp.asarray(img.real), jnp.asarray(img.imag))
    assert _rel(_c(rows), _ref_c(want_rows)) < TOL
    # The columns over the whole width, and over slabs of width n / d (as
    # the pencil FFT gives them after its all-to-all).
    cols = ours.apply_cols(*rows)
    want = ref.apply_cols(*want_rows)
    assert _rel(_c(cols), _ref_c(want)) < TOL
    w = n // d
    for j in (0, d - 1):
        slab = (rows[0][..., j * w:(j + 1) * w], rows[1][..., j * w:(j + 1) * w])
        got = ours.apply_cols(*slab)
        ref_slab = ref.apply_cols(want_rows[0][..., j * w:(j + 1) * w], want_rows[1][..., j * w:(j + 1) * w])
        assert got[0].shape == (2, n2, w)
        assert _rel(_c(got), _ref_c(ref_slab)) < TOL
    full = np.fft.fft2(img.astype(np.complex128)) if kind == "fft2" else np.fft.ifft2(img.astype(np.complex128))
    assert _rel(_c(cols), full) < NP_TOL
    assert ours.pass_claims == ("torch",) * len(ours.passes)


def test_apply_halves_refuse():
    one = F.plan(F.FFTSpec(n=64), device="cpu")
    x = _planes(_complex((8, 64), 3))
    with pytest.raises(faults.PlanError, match="apply_rows needs a 2-D complex plan, not 'fft'"):
        one.apply_rows(*x)
    with pytest.raises(faults.PlanError, match="apply_cols needs a 2-D complex plan, not 'fft'"):
        one.apply_cols(*x)
    two = F.plan(F.FFTSpec(n=64, kind="fft2", n2=16), device="cpu")
    with pytest.raises(faults.PlanError, match="plan is for n2=16 columns, got 8"):
        two.apply_cols(*x)
    with pytest.raises(faults.PlanError, match="rows of n=64"):
        two.apply_rows(*_planes(_complex((16, 32), 3)))
    assert one.pass_claims == ("torch",) * len(one.passes)


def test_apply_halves_differentiate():
    """Each half is an autograd leaf: its vjp is the other direction's half."""
    img = _complex((1, 16, 32), 4)
    two = F.plan(F.FFTSpec(n=32, kind="fft2", n2=16), device="cpu")
    xr, xi = (t.requires_grad_() for t in _planes(img))
    yr, yi = two.apply_cols(*two.apply_rows(xr, xi))
    (yr.square().sum() + yi.square().sum()).backward()
    # Parseval: d/dx Σ|F x|² = 2·N·x.
    np.testing.assert_allclose(xr.grad.numpy(), 2 * 512 * img.real, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(xi.grad.numpy(), 2 * 512 * img.imag, rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# StreamingConv under SPMD
# ---------------------------------------------------------------------------


def test_streaming_conv_spmd_block_is_modeled():
    h = np.random.default_rng(13).standard_normal(257).astype(np.float32)
    before = len(tuning.measure_log())
    sc = O.StreamingConv(torch.from_numpy(h), chunk_hint=4096, spmd=True)
    assert sc.block == tuning.modeled_block(4096, 257, 1, "cpu", chunk=4096)
    assert sc.block == ref_ov.StreamingConv(jnp.asarray(h), chunk_hint=4096, spmd=True).block
    assert len(tuning.measure_log()) == before  # no timings taken
    x = np.random.default_rng(14).standard_normal(10000).astype(np.float32)
    state = sc.init_state()
    y1, state = sc(torch.from_numpy(x[:4096]), state)
    y2, state = sc(torch.from_numpy(x[4096:]), state)
    y = np.concatenate([y1.numpy(), y2.numpy()])
    np.testing.assert_allclose(y, np.convolve(x, h)[: x.shape[-1]], atol=5e-3)
