"""The spectral mixer (``repro_torch.models.layers.spectral``) on the CPU route.

The reference's ``spectral_init`` parameters are carried into
``SpectralMixer`` by ``load_reference_params``; then the same seeded inputs
go through both: the forward, the ring decode token for token, the stream
decode after prompts that straddle the chunk C, the re-phase of a fresh
state, and a prompt long enough to route its prefill through overlap-save.
Held at 1e-3·max|ref| (and the stream decode against the port's own
one-shot forward, as ``tests/test_decode_equiv.py`` holds the reference).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig
from repro.models.layers import spectral as ref_spec
from repro.utils.params import unzip
from repro_torch import kernels
from repro_torch.core import faults
from repro_torch.core import fft as F
from repro_torch.core import plan as plan_lib
from repro_torch.models.layers.spectral import SpectralMixer, stream_grain
from repro_torch.utils.params import load_reference_params

TOL = 1e-3
D, LF = 8, 16
CFG = ModelConfig(d_model=D, spectral_filter_len=LF, compute_dtype="float32")
C, BLOCK = ref_spec.stream_grain(CFG)  # 8, 32


@pytest.fixture(autouse=True)
def _reference_untuned(monkeypatch):
    # The reference's prefill routes through overlap-save with tune=None;
    # "off" keeps it on the fixed block and out of the tuning cache.
    monkeypatch.setenv("REPRO_FFT_TUNE", "off")


def _ref_params(cfg=CFG, seed=0):
    params, _ = unzip(ref_spec.spectral_init(jax.random.PRNGKey(seed), cfg, jnp.float32))
    return params


def _mixer(cfg=CFG, params=None, mode=None):
    params = _ref_params(cfg) if params is None else params
    m = SpectralMixer(cfg.d_model, cfg.spectral_filter_len, decode_chunk=cfg.spectral_decode_chunk,
                      decode_mode=mode or cfg.spectral_decode_mode, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    return load_reference_params(m, {k: np.asarray(v) for k, v in params.items()})


def _x(shape, seed=1):
    return (0.5 * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _rel(got, ref):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.abs(got.astype(np.float64) - ref).max() / max(np.abs(ref).max(), 1e-30)


# ---------------------------------------------------------------------------
# construction and weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lf,chunk", [(16, 0), (8, 0), (1024, 0), (33, 0), (64, 5), (4, 16)])
def test_stream_grain_matches_reference(lf, chunk):
    cfg = ModelConfig(spectral_filter_len=lf, spectral_decode_chunk=chunk)
    assert stream_grain(lf, chunk) == ref_spec.stream_grain(cfg)


def test_load_reference_params_carries_every_value():
    params = _ref_params()
    m = _mixer(params=params)
    for name in ("filt", "w_gate", "w_in", "w_out"):
        np.testing.assert_array_equal(getattr(m, name).detach().numpy(), np.asarray(params[name]))
    assert m.w_in.shape == (D, D) and m.filt.shape == (D, LF)


def test_load_reference_params_refuses_mismatches():
    tree = {k: np.asarray(v) for k, v in _ref_params().items()}
    m = SpectralMixer(D, LF, device="cpu")
    with pytest.raises(KeyError, match="missing"):
        load_reference_params(m, {k: v for k, v in tree.items() if k != "w_out"})
    with pytest.raises(KeyError, match="unexpected"):
        load_reference_params(m, {**tree, "bias": np.zeros(D)})
    with pytest.raises(ValueError, match="shape"):
        load_reference_params(m, {**tree, "filt": tree["filt"][:, :4]})


def test_init_draws_the_decaying_envelope():
    gen = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    a = SpectralMixer(64, 256, device="cpu", generator=gen())
    b = SpectralMixer(64, 256, device="cpu", generator=gen())
    assert torch.equal(a.filt, b.filt) and torch.equal(a.w_out, b.w_out)
    ref = np.asarray(_ref_params(ModelConfig(d_model=64, spectral_filter_len=256))["filt"])
    got = a.filt.detach().numpy()
    # Same law, not the same draws: per-tap RMS over channels decays alike.
    for j in (0, 16, 128):
        assert abs(np.sqrt((got[:, j] ** 2).mean()) / np.sqrt((ref[:, j] ** 2).mean()) - 1) < 0.5
    assert np.abs(got[:, -32:]).max() < np.abs(got[:, :32]).max()
    assert a.w_gate.dtype == torch.float32
    assert SpectralMixer(8, 16, device="cpu", dtype=torch.bfloat16).w_in.dtype == torch.bfloat16


def test_mixer_without_a_device_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(faults.PlanError, match="no CUDA device"):
        SpectralMixer(D, LF)
    with pytest.raises(ValueError, match="decode_mode"):
        SpectralMixer(D, LF, device="cpu", decode_mode="tape")


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", [1, 5, 40, 100])
def test_forward_matches_reference(s):
    params = _ref_params()
    x = _x((2, s, D), seed=s)
    ref = _ref_forward(params, x)
    with torch.no_grad():
        got = _mixer(params=params)(torch.from_numpy(x))
    assert _rel(got, ref) <= TOL


def test_forward_bf16_keeps_the_dtype():
    x = torch.from_numpy(_x((2, 24, D))).to(torch.bfloat16)
    with torch.no_grad():
        y = _mixer()(x)
        y32 = _mixer()(x.float())
    assert y.dtype == torch.bfloat16
    assert _rel(y.float(), y32.numpy()) <= 0.05


def test_forward_empty_batch_runs_nothing():
    kernels.reset_counts()
    with torch.no_grad():
        y = _mixer()(torch.zeros(0, 12, D))
    assert tuple(y.shape) == (0, 12, D)
    assert sum(kernels.counts().values()) == 0


def test_init_caches_match_reference():
    m = _mixer()
    ring, ref_ring = m.init_cache(3), ref_spec.init_spectral_cache(CFG, 3)
    assert tuple(ring.buf.shape) == ref_ring.buf.shape and ring.t == 0
    st, ref_st = m.init_stream_cache(3), ref_spec.init_spectral_stream_cache(CFG, 3)
    for name in ("hist", "chunk", "future"):
        assert tuple(getattr(st, name).shape) == getattr(ref_st, name).shape
    assert st.phase == 0


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def _ref_step(params, fn, cfg=CFG):
    return jax.jit(lambda xt, cc: fn(params, xt, cc, cfg=cfg))


def _ref_forward(params, x, cfg=CFG, return_cache=False):
    """The reference's forward under one ``jax.jit``."""
    fn = jax.jit(lambda a: ref_spec.spectral_forward(params, a, cfg=cfg, return_cache=return_cache))
    return fn(jnp.asarray(x))


@pytest.mark.parametrize("sp", [1, 7, 16, 20])
def test_ring_decode_matches_reference(sp):
    cfg = dataclasses.replace(CFG, spectral_decode_mode="ring")
    params = _ref_params(cfg)
    m = _mixer(cfg, params)
    S = sp + 10
    x = _x((2, S, D), seed=sp)
    with torch.no_grad():
        full = m(torch.from_numpy(x)).numpy()
        _, cache = m(torch.from_numpy(x[:, :sp]), return_cache=True)
    _, rc = _ref_forward(params, x[:, :sp], cfg, return_cache=True)
    assert cache.t == sp and _rel(cache.buf, rc.buf) <= TOL
    step = _ref_step(params, ref_spec.spectral_decode)
    for t in range(sp, S):
        xt = x[:, t:t + 1]
        with torch.no_grad():
            y, cache = m.decode(torch.from_numpy(xt), cache)
        yr, rc = step(jnp.asarray(xt), rc)
        assert _rel(y, yr) <= TOL, t
        assert _rel(y[:, 0], full[:, t]) <= TOL, t
    assert cache.t == S


def test_ring_decode_from_an_empty_cache():
    params = _ref_params()
    m = _mixer(params=params)
    x = _x((2, 5, D))
    cache, rc = m.init_cache(2), ref_spec.init_spectral_cache(CFG, 2)
    step = _ref_step(params, ref_spec.spectral_decode)
    for t in range(5):
        with torch.no_grad():
            y, cache = m.decode(torch.from_numpy(x[:, t:t + 1]), cache)
        yr, rc = step(jnp.asarray(x[:, t:t + 1]), rc)
        assert _rel(y, yr) <= TOL


@pytest.mark.parametrize("sp", [1, C - 1, C, C + 3, 3 * C + 5])
def test_stream_decode_matches_reference_and_forward(sp):
    """Prompts shorter than C, equal to it and straddling it, then 2C + 3
    tokens: at least two flushes in flight."""
    params = _ref_params()
    m = _mixer(params=params)
    S = sp + 2 * C + 3
    x = _x((2, S, D), seed=sp)
    with torch.no_grad():
        full = m(torch.from_numpy(x)).numpy()
        _, cache = m(torch.from_numpy(x[:, :sp]), return_cache=True)
    _, rc = _ref_forward(params, x[:, :sp], return_cache=True)
    for name in ("hist", "future"):
        assert _rel(getattr(cache, name), getattr(rc, name)) <= TOL, name
    step = _ref_step(params, ref_spec.spectral_stream_decode)
    for t in range(sp, S):
        xt = x[:, t:t + 1]
        with torch.no_grad():
            y, cache = m.stream_decode(torch.from_numpy(xt), cache)
        yr, rc = step(jnp.asarray(xt), rc)
        assert _rel(y, yr) <= TOL, t
        assert _rel(y[:, 0], full[:, t]) <= TOL, t
        assert cache.phase == int(rc.phase)
    assert isinstance(cache.phase, int)


def test_stream_decode_with_a_filter_shorter_than_the_chunk():
    cfg = ModelConfig(d_model=4, spectral_filter_len=4, spectral_decode_chunk=16)
    params = _ref_params(cfg)
    m = _mixer(cfg, params)
    x = _x((1, 40, 4))
    with torch.no_grad():
        full = m(torch.from_numpy(x)).numpy()
        _, cache = m(torch.from_numpy(x[:, :3]), return_cache=True)
        for t in range(3, 40):
            y, cache = m.stream_decode(torch.from_numpy(x[:, t:t + 1]), cache)
            assert _rel(y[:, 0], full[:, t]) <= TOL, t


@pytest.mark.parametrize("f", [0, 1, C - 1])
def test_stream_rephase_matches_reference(f):
    params = _ref_params()
    m = _mixer(params=params)
    sp, steps = 13, 2 * C
    x = _x((2, sp + steps, D), seed=f)
    with torch.no_grad():
        _, cache = m(torch.from_numpy(x[:, :sp]), return_cache=True)
        cache = m.stream_rephase(cache, f)
    _, rc = _ref_forward(params, x[:, :sp], return_cache=True)
    rc = ref_spec.spectral_stream_rephase(params["filt"], rc, f, cfg=CFG)
    assert cache.phase == int(rc.phase) == f
    for name in ("hist", "chunk", "future"):
        assert _rel(getattr(cache, name), getattr(rc, name)) <= TOL, name
    # The re-phased state decodes on exactly as the reference's does.
    step = _ref_step(params, ref_spec.spectral_stream_decode)
    for t in range(sp, sp + steps):
        xt = x[:, t:t + 1]
        with torch.no_grad():
            y, cache = m.stream_decode(torch.from_numpy(xt), cache)
        yr, rc = step(jnp.asarray(xt), rc)
        assert _rel(y, yr) <= TOL, t


def test_stream_rephase_refuses_a_phase_outside_the_chunk():
    m = _mixer()
    with pytest.raises(ValueError, match="phase"):
        m.stream_rephase(m.init_stream_cache(1), C)


def test_warm_stream_decode_plans_nothing():
    m = _mixer()
    x = _x((2, 40, D))
    with torch.no_grad():
        _, cache = m(torch.from_numpy(x[:, :9]), return_cache=True)
        for t in range(9, 9 + C):  # one flush: every plan of the path exists
            _, cache = m.stream_decode(torch.from_numpy(x[:, t:t + 1]), cache)
        F.clear_plan_log()
        for t in range(9 + C, 9 + 3 * C):  # two more flushes
            _, cache = m.stream_decode(torch.from_numpy(x[:, t:t + 1]), cache)
    assert F.plan_log() == ()


def test_stream_prefill_through_overlap_save():
    """A prompt past FUSED_MAX: the prefill conv routes through overlap-save
    (no plan past the fused regime) and the stream continues the sequence,
    as the reference's ``test_spectral_stream_past_fused_regime``."""
    cfg = ModelConfig(d_model=2, spectral_filter_len=32, compute_dtype="float32")
    params = _ref_params(cfg)
    m = _mixer(cfg, params)
    c, _ = stream_grain(32)
    s, t_steps = plan_lib.FUSED_MAX + 64, c + 2
    x = (0.1 * np.random.default_rng(1).standard_normal((1, s + t_steps, 2))).astype(np.float32)
    F._plan_cached.cache_clear()  # so the log shows every plan the prefill needs
    F.clear_plan_log()
    with torch.no_grad():
        _, cache = m(torch.from_numpy(x[:, :s]), return_cache=True)
        assert F.plan_log() and all(spec.n <= plan_lib.FUSED_MAX for spec, _ in F.plan_log())
        ref = m(torch.from_numpy(x)).numpy()
        for i in range(t_steps):
            y, cache = m.stream_decode(torch.from_numpy(x[:, s + i:s + i + 1]), cache)
            assert _rel(y[:, 0], ref[:, s + i]) <= TOL, i
    ref_fwd = _ref_forward(params, x, cfg)
    assert _rel(ref, ref_fwd) <= TOL


def test_stream_state_of_an_empty_batch_runs_nothing():
    m = _mixer()
    kernels.reset_counts()
    with torch.no_grad():
        y, cache = m(torch.zeros(0, 20, D), return_cache=True)
        z, cache = m.stream_decode(torch.zeros(0, 1, D), cache)
        cache = m.stream_rephase(cache, 3)
    assert tuple(y.shape) == (0, 20, D) and tuple(z.shape) == (0, 1, D)
    assert tuple(cache.future.shape) == (0, D, C) and cache.phase == 3
    assert sum(kernels.counts().values()) == 0
