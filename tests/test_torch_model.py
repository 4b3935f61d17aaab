"""The decoder LM (``repro_torch.configs``, ``models``) against the reference.

Each layer at reduced sizes (``make_reduced``, d_model 64), the blocks and
the whole model: the reference's parameters go into the port through
``load_reference_params`` / ``load_reference_model``, the same seeded
inputs through both, the reference jitted with ``REPRO_FFT_TUNE=off``.
Tolerance: 1e-4·max|ref| at float32 compute; 5e-2·max|ref| at bfloat16
compute (where each side rounds its own intermediate products, a few ulps of
bf16 through the layers).  Decode is also held against the port's own full
forward, as ``tests/test_decode_equiv.py`` holds the reference.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.configs.reduce import make_reduced as ref_make_reduced
from repro.models import blocks as ref_blocks
from repro.models import model as ref_model
from repro.models.layers import attention as ref_attn
from repro.models.layers import embedding as ref_emb
from repro.models.layers import mlp as ref_mlp
from repro.models.layers import norms as ref_norms
from repro.models.layers import rope as ref_rope
from repro.utils.params import unzip
from repro_torch.configs import base
from repro_torch.configs.reduce import make_reduced
from repro_torch.core import faults
from repro_torch.models import blocks, stack
from repro_torch.models.layers import attention, embedding, mlp, norms, rope
from repro_torch.models.model import DecoderLM
from repro_torch.utils.params import load_reference_model, load_reference_params

TOL = 1e-4
TOL_BF16 = 5e-2


@pytest.fixture(autouse=True)
def _reference_untuned(monkeypatch):
    monkeypatch.setenv("REPRO_FFT_TUNE", "off")


def _cfgs(spectral=False, reduce=True, **changes):
    """The same configuration as the reference's and as the port's."""
    ref = dataclasses.replace(ref_base.get_config("h2o-danube-1.8b"), use_spectral_mixer=spectral)
    port = dataclasses.replace(base.get_config("h2o-danube-1.8b"), use_spectral_mixer=spectral)
    if reduce:
        ref, port = ref_make_reduced(ref), make_reduced(port)
    changes.setdefault("compute_dtype", "float32")
    ref, port = dataclasses.replace(ref, **changes), dataclasses.replace(port, **changes)
    assert dataclasses.asdict(ref) == dataclasses.asdict(port)
    return ref, port


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _x(shape, seed=1, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _rel(got, ref):
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float64)
    ref = np.asarray(jnp.asarray(ref, jnp.float32), np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a)).to(dtype)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spectral", [False, True])
def test_config_and_reduction_copy_the_reference(spectral):
    ref, port = _cfgs(spectral, reduce=False, compute_dtype="bfloat16")
    assert port.pattern() == ref.pattern()
    assert len(port.pattern()) == 24
    assert port.pattern()[:2] == (("spectral", "attn") if spectral else ("attn_local", "attn_local"))
    ref_r, port_r = _cfgs(spectral)
    assert port_r.pattern() == ref_r.pattern() and port_r.d_model == 64
    assert {k: dataclasses.asdict(v) for k, v in base.LM_SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in ref_base.LM_SHAPES.items()}


PORTED = ["arctic-480b", "deepseek-moe-16b", "gemma3-12b", "h2o-danube-1.8b", "yi-6b", "phi4-mini-3.8b",
          "zamba2-2.7b", "xlstm-125m", "musicgen-large", "qwen2-vl-72b"]


@pytest.mark.parametrize("arch", sorted(set(ref_base.list_archs()) - set(PORTED)))
def test_unported_archs_name_the_roadmap(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP.md A1"):
        base.get_config(arch)


@pytest.mark.parametrize("arch", PORTED)
def test_registered_configs_copy_the_reference(arch):
    """Each registered config field for field the reference's, and its
    pattern (deepseek-moe-16b's 28 layers with the spectral flag:
    ``("spectral", "moe") × 14``; arctic-480b's 35 take no flag; the
    explicit patterns of zamba2-2.7b, ``(mamba2 × 6, shared_attn) × 9``, and
    xlstm-125m, ``(mlstm, mlstm, slstm) × 4``, win over the flag, and
    ``make_reduced`` keeps two of their units)."""
    ref, port = ref_base.get_config(arch), base.get_config(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.pattern() == ref.pattern()
    if arch == "deepseek-moe-16b":
        flagged = dataclasses.replace(port, use_spectral_mixer=True)
        assert flagged.pattern() == ("spectral", "moe") * (port.num_layers // 2)
    if port.block_pattern:
        unit = stack.find_unit(port.pattern())
        assert dataclasses.replace(port, use_spectral_mixer=True).pattern() == port.pattern()
        assert make_reduced(port).pattern() == unit * 2 == ref_make_reduced(ref).pattern()
        assert unit == {"zamba2-2.7b": ("mamba2",) * 6 + ("shared_attn",),
                        "xlstm-125m": ("mlstm", "mlstm", "slstm")}[arch]


def test_registry():
    assert base.list_archs() == PORTED
    with pytest.raises(KeyError, match="unknown arch"):
        base.get_config("llama-9000")
    cfg = dataclasses.replace(base.get_config("h2o-danube-1.8b"), name="mine")
    base.register("mine", cfg)
    assert base.get_config("mine") is cfg


def test_unknown_block_kind_raises():
    _, cfg = _cfgs()
    assert blocks.KINDS == ("attn", "attn_local", "moe", "mamba2", "mlstm", "slstm", "shared_attn", "spectral")
    with pytest.raises(ValueError, match="unknown block kind"):
        blocks.Block("conv", cfg, device="cpu")


def test_find_unit_is_the_reference():
    from repro.models.stack import find_unit as ref_find_unit

    for p in [("a",) * 4, ("a", "b") * 3, ("a", "a", "b") * 2, ("a", "b", "c"), ("spectral", "attn") * 12]:
        assert stack.find_unit(p) == ref_find_unit(p)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_and_layer_norm(dtype):
    x = _x((2, 5, 64), scale=3.0)
    scale, bias = _x((64,), seed=2), _x((64,), seed=3)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    ref = ref_norms.rms_norm({"scale": jnp.asarray(scale)}, jnp.asarray(x, jd))
    got = norms.rms_norm(_t(x, td), _t(scale))
    assert got.dtype == td
    assert _rel(got, ref) <= (TOL if dtype == "float32" else 1e-2)
    ref = ref_norms.layer_norm({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}, jnp.asarray(x, jd))
    got = norms.layer_norm(_t(x, td), _t(scale), _t(bias))
    assert got.dtype == td
    assert _rel(got, ref) <= (TOL if dtype == "float32" else 1e-2)
    module = norms.RMSNorm(64, device="cpu")
    assert module.scale.dtype == torch.float32 and bool((module.scale == 1).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_matches_reference(dtype):
    np.testing.assert_array_equal(rope.rope_freqs(80, 10000.0), ref_rope.rope_freqs(80, 10000.0))
    x = _x((2, 7, 3, 16))
    pos = np.stack([np.arange(7), np.arange(100, 107)])
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    ref = ref_rope.apply_rope(jnp.asarray(x, jd), jnp.asarray(pos), 10000.0)
    got = rope.apply_rope(_t(x, td), torch.from_numpy(pos), 10000.0)
    assert got.dtype == td
    assert _rel(got, ref) <= (TOL if dtype == "float32" else 1e-2)


def test_mrope_matches_reference():
    x = _x((2, 6, 3, 16))
    pos = np.random.default_rng(4).integers(0, 50, (2, 3, 6))
    ref = ref_rope.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 10000.0, (4, 2, 2))
    got = rope.apply_mrope(_t(x), torch.from_numpy(pos), 10000.0, (4, 2, 2))
    assert _rel(got, ref) <= TOL
    # Text tokens (t = h = w) rotate as the standard rope.
    text = np.broadcast_to(np.arange(6)[None, None], (2, 3, 6))
    same = rope.apply_mrope(_t(x), torch.from_numpy(text.copy()), 10000.0, (4, 2, 2))
    torch.testing.assert_close(same, rope.apply_rope(_t(x), torch.arange(6).expand(2, 6), 10000.0))
    with pytest.raises(ValueError, match="sections"):
        rope.apply_mrope(_t(x), torch.from_numpy(pos), 10000.0, (4, 2, 1))


@pytest.mark.parametrize("tied,softcap", [(False, None), (False, 30.0), (True, 5.0)])
def test_embed_and_head_match_reference(tied, softcap):
    ref_cfg, cfg = _cfgs(tie_embeddings=tied, final_logit_softcap=softcap)
    key = jax.random.PRNGKey(0)
    e_params, _ = unzip(ref_emb.embed_init(key, ref_cfg, jnp.float32))
    h_params, _ = unzip(ref_emb.head_init(jax.random.PRNGKey(1), ref_cfg, jnp.float32))
    emb = load_reference_params(embedding.Embedding(cfg, device="cpu"), _np(e_params))
    head = load_reference_params(embedding.Head(cfg, device="cpu"), _np(h_params))
    assert (len(list(head.parameters())) == 0) == tied
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 9))
    for dtype, tol in (("float32", TOL), ("bfloat16", 1e-2)):
        ref = ref_emb.embed_apply(e_params, jnp.asarray(toks), ref_cfg, jnp.dtype(dtype))
        got = emb(torch.from_numpy(toks), getattr(torch, dtype))
        assert _rel(got, ref) <= tol
    x = _x((2, 9, cfg.d_model))
    ref = ref_emb.head_apply(h_params, e_params, jnp.asarray(x), ref_cfg)
    with torch.no_grad():
        got = head(_t(x), emb.table)
    assert got.dtype == torch.float32 and _rel(got, ref) <= TOL
    if softcap:
        assert got.abs().max() < softcap


@pytest.mark.parametrize("act", ["silu", "gelu", "relu"])
def test_mlp_matches_reference(act):
    params, _ = unzip(ref_mlp.mlp_init(jax.random.PRNGKey(0), 64, 128, jnp.float32, act=act))
    m = load_reference_params(mlp.MLP(64, 128, act=act, device="cpu"), _np(params))
    x = _x((2, 5, 64))
    for dtype, tol in (("float32", TOL), ("bfloat16", TOL_BF16)):
        ref = ref_mlp.mlp_apply(params, jnp.asarray(x, jnp.dtype(dtype)), act=act)
        with torch.no_grad():
            got = m(_t(x, getattr(torch, dtype)))
        assert got.dtype == getattr(torch, dtype)
        assert _rel(got, ref) <= tol, dtype


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-4, 4, 101).astype(np.float32)
    ref = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    np.testing.assert_allclose(mlp.ACTIVATIONS["gelu"](torch.from_numpy(x)).numpy(), ref, atol=1e-6)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def _attn_pair(window=None, **changes):
    ref_cfg, cfg = _cfgs(**changes)
    params, _ = unzip(ref_attn.attn_init(jax.random.PRNGKey(0), ref_cfg, jnp.float32))
    layer = load_reference_params(attention.Attention(cfg, window=window, device="cpu"), _np(params))
    return ref_cfg, params, layer


@pytest.mark.parametrize(
    "s,window,softcap",
    [
        (20, None, None),   # full, causal
        (20, 8, None),      # full, sliding window
        (64, None, 20.0),   # at the threshold, softcapped
        (72, None, None),   # chunked (S > 64), global
        (72, 8, None),      # chunked, the KV band
        (77, 8, None),      # chunked with padding to whole blocks, the band
        (77, 30, 20.0),     # a window wider than the block, softcapped
    ],
)
def test_attention_forward_matches_reference(s, window, softcap):
    ref_cfg, params, layer = _attn_pair(window, attn_logit_softcap=softcap)
    x = _x((2, s, 64), seed=s)
    pos = np.broadcast_to(np.arange(s), (2, s))
    ref, rc = ref_attn.attn_forward(params, jnp.asarray(x), cfg=ref_cfg, positions=jnp.asarray(pos),
                                    window=window, return_cache=True)
    with torch.no_grad():
        got, cache = layer(_t(x), torch.from_numpy(pos.copy()), return_cache=True)
    assert _rel(got, ref) <= TOL
    assert _rel(cache.k, rc.k) <= TOL and _rel(cache.v, rc.v) <= TOL


def test_chunked_attention_equals_the_full_mask():
    """Above the threshold the q-block loop (and the band) computes exactly
    the masked attention the full path computes."""
    _, _, layer = _attn_pair(8)
    x = torch.from_numpy(_x((1, 77, 64)))
    pos = torch.arange(77)[None]
    with torch.no_grad():
        chunked = layer(x, pos)
        layer.cfg = dataclasses.replace(layer.cfg, attn_chunk_threshold=4096)
        full = layer(x, pos)
    torch.testing.assert_close(chunked, full, rtol=0, atol=1e-5)


@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("cache_kind", ["bf16", "int8"])
@pytest.mark.parametrize("per_slot", [False, True])
def test_attention_decode_matches_reference(window, cache_kind, per_slot):
    """Decode from an empty cache, 12 steps (a window ring wraps): a scalar t
    for the whole batch, or per-slot positions three apart.  "bf16": the
    cache in the compute dtype, at bf16 compute; "int8": quantised at
    float32 compute."""
    bf16 = cache_kind == "bf16"
    ref_cfg, params, layer = _attn_pair(window, kv_cache_dtype=cache_kind,
                                        compute_dtype="bfloat16" if bf16 else "float32")
    cd, td = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    b, max_len = 2, 20
    rc = ref_attn.init_kv_cache(ref_cfg, b, max_len, window=window, dtype=cd)
    cache = attention.init_kv_cache(layer.cfg, b, max_len, window=window, dtype=td, device="cpu")
    assert tuple(cache.k.shape) == rc.k.shape and str(cache.k.dtype).endswith(str(rc.k.dtype))
    step = jax.jit(lambda xt, c, t: ref_attn.attn_decode(params, xt, c, t, cfg=ref_cfg, window=window))
    x = _x((b, 12, 64), seed=7)
    for i in range(12):
        t = np.array([i, i + 3]) if per_slot else np.int32(i)
        yr, rc = step(jnp.asarray(x[:, i:i + 1], cd), rc, jnp.asarray(t))
        with torch.no_grad():
            y, cache = layer.decode(_t(x[:, i:i + 1], td), cache, torch.from_numpy(t) if per_slot else int(t))
        assert y.dtype == td
        assert _rel(y, yr) <= (TOL_BF16 if bf16 else TOL), i
    assert _rel(cache.k.float(), np.asarray(rc.k, np.float32)) <= (1e-2 if bf16 else 0)
    if not bf16:
        assert _rel(cache.k_scale, rc.k_scale) <= TOL


def test_attention_decode_past_the_cache_clamps_to_the_last_slot():
    ref_cfg, params, layer = _attn_pair()
    cache = attention.init_kv_cache(layer.cfg, 1, 4, dtype=torch.float32, device="cpu")
    x = torch.from_numpy(_x((1, 1, 64)))
    with torch.no_grad():
        layer.decode(x, cache, 9)
    assert cache.k[0, :3].abs().max() == 0 and cache.k[0, 3].abs().max() > 0


@pytest.mark.parametrize("s", [20, 72])
def test_attention_refuses_mrope(s):
    """``rope_kind="mrope"``: with (B, 3, S) ids, forward (full, and chunked
    above 64) and decode at ids apart from the KV slot match the
    reference's; without ids it rotates by ``positions`` as the reference;
    sections that do not fill head_dim / 2 are refused."""
    ref_cfg, params, layer = _attn_pair(rope_kind="mrope", mrope_sections=(4, 2, 2))
    x = _x((2, s, 64), seed=s)
    pos = np.broadcast_to(np.arange(s), (2, s))
    ids = np.stack([np.zeros(s, np.int64), np.arange(s) // 3, np.arange(s) % 5])[None].repeat(2, 0)
    for mp in (ids, None):
        ref = ref_attn.attn_forward(params, jnp.asarray(x), cfg=ref_cfg, positions=jnp.asarray(pos),
                                    mrope_positions=None if mp is None else jnp.asarray(mp))
        with torch.no_grad():
            got = layer(_t(x), torch.from_numpy(pos.copy()),
                        mrope_positions=None if mp is None else torch.from_numpy(mp))
        assert _rel(got, ref) <= TOL
    rc = ref_attn.init_kv_cache(ref_cfg, 2, 8, dtype=jnp.float32)
    cache = attention.init_kv_cache(layer.cfg, 2, 8, dtype=torch.float32, device="cpu")
    for t in range(4):
        mp = ids[:, :, t + 7:t + 8]
        yr, rc = ref_attn.attn_decode(params, jnp.asarray(x[:, t:t + 1]), rc, jnp.asarray(t, jnp.int32), cfg=ref_cfg,
                                      mrope_positions=jnp.asarray(mp))
        with torch.no_grad():
            y, cache = layer.decode(_t(x[:, t:t + 1]), cache, t, torch.from_numpy(mp))
        assert _rel(y, yr) <= TOL, t
    layer.cfg = dataclasses.replace(layer.cfg, mrope_sections=(4, 2, 1))
    with pytest.raises(ValueError, match="sections"):
        layer(_t(x), torch.from_numpy(pos.copy()), mrope_positions=torch.from_numpy(ids))


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,mode", [("attn", None), ("attn_local", None), ("spectral", "stream"),
                                       ("spectral", "ring")])
def test_block_forward_and_decode_match_reference(kind, mode):
    ref_cfg, cfg = _cfgs(spectral_decode_mode=mode or "stream")
    params, _ = unzip(ref_blocks.block_init(jax.random.PRNGKey(0), kind, ref_cfg, jnp.float32))
    block = load_reference_params(blocks.Block(kind, cfg, device="cpu"), _np(params))
    s, sp = 30, 20
    x = _x((2, s, 64), seed=3)
    pos = np.broadcast_to(np.arange(sp), (2, sp))
    ref_fwd = jax.jit(lambda a, p: ref_blocks.block_forward(params, a, kind=kind, cfg=ref_cfg, positions=p,
                                                            return_cache=True))
    yr, rc, _ = ref_fwd(jnp.asarray(x[:, :sp]), jnp.asarray(pos))
    with torch.no_grad():
        y, cache, _ = block(_t(x[:, :sp]), torch.from_numpy(pos.copy()), return_cache=True)
        full, _, _ = block(_t(x), torch.arange(s).expand(2, s))
    assert _rel(y, yr) <= TOL
    if kind != "spectral":  # decode from the prefill's KV, padded to the decode layout
        window = cfg.sliding_window if kind == "attn_local" else None
        rc = ref_attn.init_kv_cache(ref_cfg, 2, s, window=window, dtype=jnp.float32)
        cache = block.cache_init(2, s, torch.float32)
        x_steps = range(0, s)
    else:
        x_steps = range(sp, s)
    step = jax.jit(lambda a, c, t: ref_blocks.block_decode(params, a, c, t, kind=kind, cfg=ref_cfg))
    for t in x_steps:
        yr, rc = step(jnp.asarray(x[:, t:t + 1]), rc, jnp.asarray(t, jnp.int32))
        with torch.no_grad():
            y, cache = block.decode(_t(x[:, t:t + 1]), cache, t)
        assert _rel(y, yr) <= TOL, t
        assert _rel(y[:, 0], full[:, t].numpy()) <= TOL, t


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------


def _model_pair(spectral, **changes):
    ref_cfg, cfg = _cfgs(spectral, **changes)
    params, _ = ref_model.init_unzipped(jax.random.PRNGKey(0), ref_cfg)
    return ref_cfg, params, load_reference_model(DecoderLM(cfg, device="cpu"), _np(params))


@pytest.fixture(scope="module", params=[True, False], ids=["hybrid", "plain"])
def pair(request):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_FFT_TUNE", "off")
        yield _model_pair(request.param)


def test_reduced_patterns():
    assert _cfgs(True)[1].pattern() == ("spectral", "attn") * 2
    assert _cfgs(False)[1].pattern() == ("attn_local",) * 2


@pytest.mark.parametrize("s", [12, 80])
def test_logits_match_reference(pair, s):
    """Below and above the chunk threshold (64): the plain reduced
    h2o-danube's band and the hybrid's global chunked attention."""
    _check_logits(pair, s)


def _check_logits(pair, s):
    ref_cfg, params, model = pair
    toks = np.random.default_rng(s).integers(0, 512, (2, s))
    ref = jax.jit(lambda p, t: ref_model.logits_fn(p, {"tokens": t}, ref_cfg)[0])(params, jnp.asarray(toks))
    with torch.no_grad():
        got = model.logits_fn(torch.from_numpy(toks))
    assert got.shape == (2, s, 512) and got.dtype == torch.float32
    assert _rel(got, ref) <= TOL


@pytest.mark.parametrize("sp", [5, 70])
def test_prefill_and_decode_match_reference(pair, sp):
    """prefill, the decode-layout caches and every decode step against the
    reference's, and each step's logits against the full forward."""
    _check_prefill_and_decode(pair, sp)


def _check_prefill_and_decode(pair, sp, against_full=True):
    """... and, ``against_full``, each decode step against the port's own
    full forward."""
    ref_cfg, params, model = pair
    total, max_len = sp + 11, sp + 16
    toks = np.random.default_rng(sp).integers(0, 512, (2, total))
    lp, rc = jax.jit(lambda p, t: ref_model.prefill(p, {"tokens": t}, ref_cfg))(params, jnp.asarray(toks[:, :sp]))
    rc = ref_model.prepare_decode_caches(rc, ref_cfg, sp, max_len)
    got_lp, cache = model.prefill(torch.from_numpy(toks[:, :sp]))
    cache = model.prepare_decode_caches(cache, max_len)
    assert _rel(got_lp, lp) <= TOL
    unit = stack.find_unit(ref_cfg.pattern())
    for layer, c in enumerate(cache):
        ref_c = jax.tree.map(lambda a, r=layer // len(unit): a[r], rc[layer % len(unit)])
        for name, a in c._asdict().items():
            if torch.is_tensor(a):
                assert tuple(a.shape) == getattr(ref_c, name).shape, (layer, name)
                assert _rel(a, getattr(ref_c, name)) <= TOL, (layer, name)
    with torch.no_grad():
        full = model.logits_fn(torch.from_numpy(toks)).numpy()
    step = jax.jit(lambda p, tk, c, t: ref_model.decode_step(p, tk, c, t, ref_cfg))
    for t in range(sp, total):
        lg, rc = step(params, jnp.asarray(toks[:, t]), rc, jnp.asarray(t, jnp.int32))
        got, cache = model.decode_step(torch.from_numpy(toks[:, t]), cache, t)
        assert _rel(got, lg) <= TOL, t
        assert not against_full or _rel(got, full[:, t]) <= TOL, t


#: Registry name → the changes on top of its reduced config.
ARCHS = {
    "gemma3-12b": {},
    "yi-6b": {},
    "phi4-mini-3.8b": {},
    "deepseek-moe-16b": {},
    "deepseek-moe-16b+spectral": {"use_spectral_mixer": True},
    "arctic-480b": {"param_dtype": "bfloat16"},
}


def _arch_cfgs(name, **changes):
    """The reduced config of ``name`` (``+spectral``: with the flag) as the
    reference's and the port's, at float32 compute."""
    arch = name.split("+")[0]
    changes = {"compute_dtype": "float32", **ARCHS[name], **changes}
    flag = changes.pop("use_spectral_mixer", False)
    ref_cfg = ref_make_reduced(dataclasses.replace(ref_base.get_config(arch), use_spectral_mixer=flag))
    cfg = make_reduced(dataclasses.replace(base.get_config(arch), use_spectral_mixer=flag))
    ref_cfg, cfg = dataclasses.replace(ref_cfg, **changes), dataclasses.replace(cfg, **changes)
    assert dataclasses.asdict(ref_cfg) == dataclasses.asdict(cfg)
    return ref_cfg, cfg


@pytest.fixture(scope="module", params=list(ARCHS))
def arch_pair(request):
    """Another registered config at reduced size: gemma3-12b (5:1 local to
    global windows, tied head, final softcap, GeGLU), yi-6b and
    phi4-mini-3.8b (global GQA), deepseek-moe-16b plain (``moe`` × 2) and
    with the spectral flag (``("spectral", "moe") × 2``), arctic-480b (MoE
    with the dense residual, GQA, bf16 parameters, int8 KV cache)."""
    ref_cfg, cfg = _arch_cfgs(request.param)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_FFT_TUNE", "off")
        params, _ = ref_model.init_unzipped(jax.random.PRNGKey(0), ref_cfg)
        yield ref_cfg, params, load_reference_model(DecoderLM(cfg, device="cpu"), _np(params))


def test_config_logits_match_reference(arch_pair):
    """Above the chunk threshold (64): chunked attention, banded on gemma3's
    local layers."""
    _check_logits(arch_pair, 80)


def test_config_prefill_and_decode_match_reference(arch_pair):
    """Against the reference at every config's own capacity.  An MoE
    forward over 81 tokens drops assignments where a decode step (capacity
    k for its one token) drops none, as the reference's, so the MoE
    configs' decode is held to their full forward in
    :func:`test_moe_decode_equals_the_full_forward_without_drops`."""
    _check_prefill_and_decode(arch_pair, 70, against_full=arch_pair[2].cfg.family != "moe")


MOE_ARCHS = [name for name in ARCHS if name.startswith(("deepseek", "arctic"))]


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_decode_equals_the_full_forward_without_drops(name):
    """capacity_factor = E/k: every row's capacity is at least its length,
    so nothing drops (an expert takes a token once), and prefill + decode
    equal the full forward, as for the dense configs.  At the default
    capacity the 70-token prefill (24 slots an expert) drops where the
    81-token forward (32) does not."""
    ref_cfg, cfg = _arch_cfgs(name)
    # The KV cache in the compute dtype: int8's rounding is not the forward's.
    ref_cfg, cfg = _arch_cfgs(name, capacity_factor=cfg.num_experts / cfg.top_k, kv_cache_dtype="bf16")
    params, _ = ref_model.init_unzipped(jax.random.PRNGKey(0), ref_cfg)
    model = load_reference_model(DecoderLM(cfg, device="cpu"), _np(params))
    _check_prefill_and_decode((ref_cfg, params, model), 70)
    toks = torch.from_numpy(np.random.default_rng(70).integers(0, 512, (2, 81)))
    moe_layers = [block.moe for block in model.stack if block.kind == "moe"]
    with torch.no_grad():
        model.logits_fn(toks)
        assert [int(m.dropped) for m in moe_layers] == [0] * len(moe_layers)
        model.prefill(toks[:, :70])
        assert [int(m.dropped) for m in moe_layers] == [0] * len(moe_layers)
        default = DecoderLM(dataclasses.replace(cfg, capacity_factor=1.25), device="cpu")
        default.load_state_dict(model.state_dict())
        default.prefill(toks[:, :70])
    assert sum(int(block.moe.dropped) for block in default.stack if block.kind == "moe") > 0


def test_moe_shared_dense_decodes_as_the_reference():
    """``tests/test_decode_equiv.py``'s ``moe_shared_dense`` case (8 experts,
    top-2, one shared expert and the dense residual, bf16 compute): the
    reference's parameters and tokens; the full logits against the
    reference's at the bf16 tolerance, and prefill + decode against the
    port's own full forward at 1e-3, as that test holds the reference."""
    kw = dict(family="moe", num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, d_ff=64, vocab_size=256,
              num_experts=8, top_k=2, num_shared_experts=1, moe_dense_residual=True)
    ref_cfg, cfg = ref_base.ModelConfig(**kw), base.ModelConfig(**kw)
    assert cfg.pattern() == ("moe", "moe") and cfg.compute_dtype == "bfloat16"
    S, Sp = 16, 10
    params, _ = ref_model.init_unzipped(jax.random.PRNGKey(0), ref_cfg)
    toks = jax.random.randint(jax.random.PRNGKey(1), (2, S), 0, cfg.vocab_size)
    ref_full, _ = ref_model.logits_fn(params, {"tokens": toks, "targets": toks}, ref_cfg)
    model = load_reference_model(DecoderLM(cfg, device="cpu"), _np(params))
    toks = torch.from_numpy(np.array(toks))
    with torch.no_grad():
        full = model.logits_fn(toks)
    assert _rel(full, ref_full) <= TOL_BF16
    lp, caches = model.prefill(toks[:, :Sp])
    caches = model.prepare_decode_caches(caches, S)
    errs = [(lp - full[:, Sp - 1]).abs().max().item()]
    for t in range(Sp, S):
        lg, caches = model.decode_step(toks[:, t], caches, t)
        errs.append((lg - full[:, t]).abs().max().item())
    assert max(errs) < 1e-3, max(errs)


def test_decode_per_slot_positions_match_reference():
    """Two rows at their own positions (a (B,) t), through the hybrid."""
    ref_cfg, params, model = _model_pair(True)
    toks = np.random.default_rng(2).integers(0, 512, (2, 9))
    lp, rc = ref_model.prefill(params, {"tokens": jnp.asarray(toks[:, :6])}, ref_cfg)
    rc = ref_model.prepare_decode_caches(rc, ref_cfg, 6, 20)
    _, cache = model.prefill(torch.from_numpy(toks[:, :6]))
    cache = model.prepare_decode_caches(cache, 20)
    t = np.array([6, 6])
    for i in range(6, 9):
        lg, rc = ref_model.decode_step(params, jnp.asarray(toks[:, i]), rc, jnp.asarray(t), ref_cfg)
        got, cache = model.decode_step(torch.from_numpy(toks[:, i]), cache, torch.from_numpy(t))
        assert _rel(got, lg) <= TOL
        t = t + 1


def test_spectral_flag_decodes_exactly():
    """As ``test_decode_equiv.py``'s ``test_spectral_mixer_flag_trains_and_decodes``:
    use_spectral_mixer alternates FFT long-conv mixing with attention, and
    decode after a prefill equals the full forward."""
    cfg = base.ModelConfig(family="dense", num_layers=4, d_model=64, num_heads=4, num_kv_heads=4, d_ff=128,
                           vocab_size=256, use_spectral_mixer=True, spectral_filter_len=8,
                           compute_dtype="float32")
    assert cfg.pattern() == ("spectral", "attn") * 2
    S, Sp = 12, 8
    model = DecoderLM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    toks = torch.randint(0, 256, (2, S), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        full = model.logits_fn(toks)
    lp, caches = model.prefill(toks[:, :Sp])
    caches = model.prepare_decode_caches(caches, S)
    errs = [(lp - full[:, Sp - 1]).abs().max().item()]
    for t in range(Sp, S):
        lg, caches = model.decode_step(toks[:, t], caches, t)
        errs.append((lg - full[:, t]).abs().max().item())
    assert max(errs) < 1e-3, max(errs)


def test_bf16_logits_match_reference():
    ref_cfg, params, model = _model_pair(True, compute_dtype="bfloat16")
    toks = np.random.default_rng(3).integers(0, 512, (2, 24))
    ref = ref_model.logits_fn(params, {"tokens": jnp.asarray(toks)}, ref_cfg)[0]
    with torch.no_grad():
        got = model.logits_fn(torch.from_numpy(toks))
    assert got.dtype == torch.float32
    assert _rel(got, ref) <= TOL_BF16


def test_int8_cache_decode_matches_reference():
    ref_cfg, params, model = _model_pair(False, kv_cache_dtype="int8")
    toks = np.random.default_rng(4).integers(0, 512, (2, 16))
    _, rc = ref_model.prefill(params, {"tokens": jnp.asarray(toks[:, :10])}, ref_cfg)
    rc = ref_model.prepare_decode_caches(rc, ref_cfg, 10, 20)
    _, cache = model.prefill(torch.from_numpy(toks[:, :10]))
    cache = model.prepare_decode_caches(cache, 20)
    assert cache[0].k.dtype == torch.int8
    for t in range(10, 16):
        lg, rc = ref_model.decode_step(params, jnp.asarray(toks[:, t]), rc, jnp.asarray(t, jnp.int32), ref_cfg)
        got, cache = model.decode_step(torch.from_numpy(toks[:, t]), cache, t)
        assert _rel(got, lg) <= TOL, t


def test_window_ring_shorter_than_the_window():
    """max_len below the window: the prepared ring has min(window, max_len)
    slots, as the empty cache, and decodes as the full forward."""
    _, _, model = _model_pair(False)
    toks = torch.randint(0, 512, (1, 7), generator=torch.Generator().manual_seed(5))
    _, cache = model.prefill(toks[:, :3])
    cache = model.prepare_decode_caches(cache, 7)
    assert tuple(cache[0].k.shape) == tuple(model.cache_init(1, 7)[0].k.shape) == (1, 7, 1, 16)
    with torch.no_grad():
        full = model.logits_fn(toks)
    for t in range(3, 7):
        lg, cache = model.decode_step(toks[:, t], cache, t)
        assert _rel(lg, full[:, t].numpy()) <= TOL


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_load_reference_model_unstacks_the_repeats():
    ref_cfg, params, model = _model_pair(True)
    unit = len(stack.find_unit(ref_cfg.pattern()))
    named = dict(model.named_parameters())
    stacked = params["stack"]["unit"]
    for layer in range(ref_cfg.num_layers):
        r, i = divmod(layer, unit)
        for name, value in _flat(stacked[f"b{i}"]).items():
            np.testing.assert_array_equal(named[f"stack.{layer}.{name}"].detach().numpy(), np.asarray(value)[r])
    np.testing.assert_array_equal(named["embed.table"].detach().numpy(), np.asarray(params["embed"]["table"]))
    np.testing.assert_array_equal(named["head.w"].detach().numpy(), np.asarray(params["head"]["w"]))
    expected = {"embed.table", "final_norm.scale", "head.w"} | {
        f"stack.{layer}.{n}" for layer in range(ref_cfg.num_layers) for n in _flat(stacked[f"b{layer % unit}"])}
    assert set(named) == expected


def test_load_reference_model_refuses_mismatches():
    ref_cfg, params, model = _model_pair(False)
    tree = _np(params)
    missing = {**tree, "final_norm": {}}
    with pytest.raises(KeyError, match="missing"):
        load_reference_model(model, missing)
    extra = {**tree, "stack": {"unit": {**tree["stack"]["unit"], "b1": tree["stack"]["unit"]["b0"]}}}
    with pytest.raises(KeyError, match="unexpected"):
        load_reference_model(model, extra)
    more_repeats = jax.tree.map(lambda a: np.concatenate([a, a]), tree["stack"])
    with pytest.raises(KeyError, match="unexpected"):
        load_reference_model(model, {**tree, "stack": more_repeats})
    wrong = {**tree, "head": {"w": tree["head"]["w"][:, :7]}}
    with pytest.raises(ValueError, match="shape"):
        load_reference_model(model, wrong)


def test_init_draws_every_parameter_at_the_reference_shape_and_scale():
    """The port's own init at full depth (a narrow width) against the
    reference's: the same names, shapes and dtypes (the loader holds them),
    each parameter's RMS at the reference's law, and the same draws from the
    same seed."""
    ref_cfg, cfg = _cfgs(True, reduce=False, d_model=128, num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256,
                         vocab_size=1000, num_layers=4, spectral_filter_len=64, compute_dtype="bfloat16")
    params, _ = ref_model.init_unzipped(jax.random.PRNGKey(0), ref_cfg)
    ref = dict(load_reference_model(DecoderLM(cfg, device="cpu"), _np(params)).named_parameters())
    named = dict(DecoderLM(cfg, device="cpu", generator=torch.Generator().manual_seed(0)).named_parameters())
    again = dict(DecoderLM(cfg, device="cpu", generator=torch.Generator().manual_seed(0)).named_parameters())
    assert set(named) == set(ref)
    for name, p in named.items():
        assert p.shape == ref[name].shape and p.dtype == torch.float32, name
        rms, ref_rms = p.detach().pow(2).mean().sqrt().item(), ref[name].detach().pow(2).mean().sqrt().item()
        assert abs(rms / ref_rms - 1) < 0.2, (name, rms, ref_rms)
        assert torch.equal(p, again[name]), name


def test_model_without_a_device_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = _cfgs(True)
    with pytest.raises(faults.PlanError, match="no CUDA device"):
        DecoderLM(cfg)
