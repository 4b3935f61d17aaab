"""The modality frontends against the reference: musicgen-large's audio
frame embeddings (plain, and with ``use_spectral_mixer``) and qwen2-vl-72b's
vision embeddings with M-RoPE ids and its int8 KV cache.

Reduced configs (``make_reduced``: d_model 64, head_dim 16, M-RoPE sections
(4, 2, 2), ``frontend_len`` 4) at float32 compute; the reference's
parameters (``init_unzipped`` at ``PRNGKey(0)``) go into the port through
``load_reference_model``, and the same seeded numpy inputs through both,
the reference jitted with ``REPRO_FFT_TUNE=off``.  The vision prompts follow
qwen2-vl's rule for M-RoPE ids: a grid of side 2 over the first 4 positions,
position i at (0, i // 2, i % 2), then text position j at 2 + j in all three
streams, so from the grid on a position's ids differ from its KV slot.
Tolerances, relative to max|ref| as in ``tests/test_torch_model.py``: 1e-4
against the reference (logits, prefill, caches, each decode step); 1e-3 for
decode against the port's own full forward; an int8 cache 0.03 against the
full forward (``tests/test_quantized_cache.py``'s bound); loss, gradients and
AdamW as ``tests/_recurrent.py``'s ``check_training``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _recurrent import check_training, np_tree, randn, rel, token_batch

from repro.configs import base as ref_base
from repro.configs.reduce import make_reduced as ref_make_reduced
from repro.models import model as ref_model
from repro.serving.engine import Engine as RefEngine
from repro.serving.engine import ServeConfig as RefServeConfig
from repro.serving.spectral_serve import ServeSession as RefSession
from repro_torch.configs import base
from repro_torch.configs.reduce import make_reduced
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models.model import DecoderLM
from repro_torch.models.stack import find_unit
from repro_torch.serving.engine import Engine, ServeConfig
from repro_torch.serving.spectral_serve import ServeSession
from repro_torch.utils.params import load_reference_model

TOL = 1e-4
DECODE_TOL = 1e-3
INT8_TOL = 0.03
SIDE = 2  # the reduced vision grid: frontend_len 4 = 2 × 2

#: Test name → (registry name, use_spectral_mixer).
ARCHS = {
    "musicgen": ("musicgen-large", False),
    "musicgen+spectral": ("musicgen-large", True),
    "qwen2-vl": ("qwen2-vl-72b", False),
}


@pytest.fixture(autouse=True)
def _reference_untuned(monkeypatch):
    monkeypatch.setenv("REPRO_FFT_TUNE", "off")


def _cfgs(name, **changes):
    """The reduced config of ``name`` as the reference's and the port's, at
    float32 compute."""
    arch, spectral = ARCHS[name]
    changes = {"compute_dtype": "float32", **changes}
    ref = ref_make_reduced(dataclasses.replace(ref_base.get_config(arch), use_spectral_mixer=spectral))
    port = make_reduced(dataclasses.replace(base.get_config(arch), use_spectral_mixer=spectral))
    ref, port = dataclasses.replace(ref, **changes), dataclasses.replace(port, **changes)
    assert dataclasses.asdict(ref) == dataclasses.asdict(port)
    return ref, port


def _pair(name, **changes):
    ref_cfg, cfg = _cfgs(name, **changes)
    params = np_tree(ref_model.init_unzipped(jax.random.PRNGKey(0), ref_cfg)[0])
    return ref_cfg, params, load_reference_model(DecoderLM(cfg, device="cpu"), params)


@pytest.fixture(scope="module", params=list(ARCHS))
def pair(request):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_FFT_TUNE", "off")
        yield _pair(request.param)


def mrope_ids(s: int) -> np.ndarray:
    """(3, s) M-RoPE ids of a prompt that starts with the vision grid."""
    n = min(SIDE * SIDE, s)
    i = np.arange(n)
    vision = np.stack([np.zeros(n, np.int64), i // SIDE, i % SIDE])
    text = np.broadcast_to(SIDE + np.arange(s - n), (3, s - n))
    return np.concatenate([vision, text], axis=1).astype(np.int32)


def _inputs(cfg, b: int, s: int, seed: int) -> dict:
    """The reference's batch keys for ``cfg`` (numpy), as
    ``tests/test_models_smoke.py`` builds them: frame embeddings for audio,
    else tokens, and for vision the patch embeddings of the first
    min(frontend_len, s) positions and the M-RoPE ids."""
    if cfg.frontend == "audio":
        return {"frame_embeds": randn((b, s, cfg.d_model), seed=seed)}
    out = {"tokens": np.random.default_rng(seed).integers(4, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.frontend == "vision":
        out["vision_embeds"] = randn((b, min(cfg.frontend_len, s), cfg.d_model), seed=seed + 1)
        out["mrope_positions"] = np.ascontiguousarray(np.broadcast_to(mrope_ids(s), (b, 3, s)))
    return out


def _port(inputs: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in inputs.items()}


def _ref_logits(ref_cfg, params, inputs):
    fn = jax.jit(lambda p, batch: ref_model.logits_fn(p, batch, ref_cfg)[0])
    return fn(params, {k: jnp.asarray(v) for k, v in inputs.items()})


# ---------------------------------------------------------------------------
# configs and parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(ARCHS))
def test_reduced_configs_copy_the_reference(name):
    ref_cfg, cfg = _cfgs(name)
    assert cfg.pattern() == ref_cfg.pattern()
    if cfg.frontend == "vision":
        assert (cfg.frontend_len, cfg.mrope_sections, cfg.kv_cache_dtype) == (4, (4, 2, 2), "int8")
    else:
        assert cfg.frontend == "audio" and cfg.pattern()[0] == ("spectral" if "spectral" in name else "attn")


@pytest.mark.parametrize("name", list(ARCHS))
def test_load_reference_model_carries_the_tree_unchanged(name):
    """The frontends add no parameter: the port holds the reference's
    reduced tree name for name and value for value (the stack unstacked),
    and the same config without its frontend has the same parameters."""
    ref_cfg, params, model = _pair(name)
    width = len(find_unit(ref_cfg.pattern()))
    want = {}
    for key, sub in params.items():
        for name_, v in jax.tree_util.tree_flatten_with_path(sub)[0]:
            path = ".".join(str(getattr(k, "key", k)) for k in name_)
            if key == "stack" and path.startswith("unit.b"):
                pos, _, rest = path[len("unit.b"):].partition(".")
                for r in range(v.shape[0]):
                    want[f"stack.{r * width + int(pos)}.{rest}"] = v[r]
            else:
                want[f"{key}.{path}"] = v
    got = {k: p.detach().numpy() for k, p in model.named_parameters()}
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    bare = DecoderLM(dataclasses.replace(model.cfg, frontend=None), device="cpu")
    assert [(k, p.shape) for k, p in bare.named_parameters()] == [(k, p.shape) for k, p in model.named_parameters()]


# ---------------------------------------------------------------------------
# logits, prefill and decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", [3, 12, 80])
def test_logits_match_reference(pair, s):
    """``logits_fn`` over the reference's batch keys: frame embeddings, or
    tokens with the vision prefix and M-RoPE ids — below the vision grid's
    length (S = 3 < frontend_len), past it, and above the chunk threshold
    (64)."""
    ref_cfg, params, model = pair
    inputs = _inputs(ref_cfg, 2, s, seed=s)
    ref = _ref_logits(ref_cfg, params, inputs)
    with torch.no_grad():
        got = model.logits_fn(**_port(inputs))
    assert got.shape == (2, s, ref_cfg.vocab_size) and got.dtype == torch.float32
    assert rel(got, ref) <= TOL
    if ref_cfg.frontend == "vision" and s < ref_cfg.frontend_len:
        # A whole grid's embeddings overwrite only the positions there are.
        grid = torch.from_numpy(randn((2, ref_cfg.frontend_len, 64), seed=s + 2))
        with torch.no_grad():
            assert torch.equal(model.logits_fn(**dict(_port(inputs), vision_embeds=grid)),
                               model.logits_fn(**dict(_port(inputs), vision_embeds=grid[:, :s])))


def test_audio_model_needs_frame_embeds():
    _, _, model = _pair("musicgen")
    with pytest.raises(ValueError, match="frame_embeds"):
        model.logits_fn(torch.zeros((1, 4), dtype=torch.long))


def _ref_prefill_and_caches(ref_cfg, params, inputs, sp, max_len):
    lp, rc = jax.jit(lambda p, batch: ref_model.prefill(p, batch, ref_cfg))(
        params, {k: jnp.asarray(v) for k, v in inputs.items()})
    return lp, ref_model.prepare_decode_caches(rc, ref_cfg, sp, max_len)


def _prefix(inputs: dict, sp: int) -> dict:
    """The first ``sp`` positions of each input (the vision prefix as it is)."""
    cut = {"tokens": lambda a: a[:, :sp], "frame_embeds": lambda a: a[:, :sp],
           "mrope_positions": lambda a: a[:, :, :sp], "vision_embeds": lambda a: a[:, :sp]}
    return {k: cut[k](v) for k, v in inputs.items()}


def _check_caches(ref_cfg, caches, rc):
    unit = find_unit(ref_cfg.pattern())
    for layer, c in enumerate(caches):
        ref_c = jax.tree.map(lambda a, r=layer // len(unit): a[r], rc[layer % len(unit)])
        for name, a in c._asdict().items():
            if torch.is_tensor(a):
                assert tuple(a.shape) == getattr(ref_c, name).shape, (layer, name)
                # int8 values: within one quantisation step (a tie rounded apart)
                assert rel(a.float(), np.asarray(getattr(ref_c, name), np.float32)) <= (
                    1 / 127 if a.dtype == torch.int8 else TOL), (layer, name)


@pytest.mark.parametrize("sp", [6, 70])
def test_prefill_and_decode_match_reference(pair, sp):
    """Prefill, the decode-layout caches and 10 decode steps against the
    reference's, each step also against the port's full forward over the
    same inputs.  Audio: 6 steps feed frame embeddings through ``embeds=``,
    4 go through the token table (the forward then sees the table's
    embedding of those tokens).  Vision: each step's (B, 3, 1) M-RoPE ids
    lie apart from its KV slot ``t``; the config's int8 cache (0.03 of the
    full forward), then the cache in the compute dtype (1e-3)."""
    ref_cfg, params, model = pair
    total, max_len = sp + 10, sp + 14
    inputs = _inputs(ref_cfg, 2, total, seed=sp)
    audio = ref_cfg.frontend == "audio"
    toks = (np.random.default_rng(sp + 7).integers(4, ref_cfg.vocab_size, (2, total)).astype(np.int32) if audio
            else inputs["tokens"])
    models = [(ref_cfg, model)]
    if ref_cfg.frontend == "vision":
        exact_cfg = dataclasses.replace(ref_cfg, kv_cache_dtype="bf16")
        twin = DecoderLM(dataclasses.replace(model.cfg, kv_cache_dtype="bf16"), device="cpu")
        twin.load_state_dict(model.state_dict())
        models.append((exact_cfg, twin))
    for rcfg, m in models:
        lp, rc = _ref_prefill_and_caches(rcfg, params, _prefix(inputs, sp), sp, max_len)
        got_lp, caches = m.prefill(**_port(_prefix(inputs, sp)))
        caches = m.prepare_decode_caches(caches, max_len)
        assert rel(got_lp, lp) <= TOL
        _check_caches(rcfg, caches, rc)
        step = jax.jit(lambda p, tk, c, t, e, mp, rcfg=rcfg: ref_model.decode_step(
            p, tk, c, t, rcfg, embeds=e, mrope_positions=mp))
        full_inputs = dict(inputs)
        if audio:  # the table steps' frames: the embedding of their tokens
            with torch.no_grad():
                table = m.embed(torch.from_numpy(toks[:, sp + 6:]), torch.float32).numpy()
            full_inputs["frame_embeds"] = np.concatenate([inputs["frame_embeds"][:, :sp + 6], table], axis=1)
        with torch.no_grad():
            full = m.logits_fn(**_port(full_inputs)).numpy()
        bound = INT8_TOL if m.cfg.kv_cache_dtype == "int8" else DECODE_TOL
        for t in range(sp, total):
            embeds = inputs["frame_embeds"][:, t:t + 1] if audio and t < sp + 6 else None
            ids = inputs["mrope_positions"][:, :, t:t + 1] if "mrope_positions" in inputs else None
            if ids is not None:
                assert (ids[:, 0, 0] != t).all()
            lg, rc = step(params, jnp.asarray(toks[:, t]), rc, jnp.asarray(t, jnp.int32),
                          None if embeds is None else jnp.asarray(embeds), None if ids is None else jnp.asarray(ids))
            got, caches = m.decode_step(torch.from_numpy(toks[:, t]), caches, t,
                                        embeds=None if embeds is None else torch.from_numpy(embeds),
                                        mrope_positions=None if ids is None else torch.from_numpy(ids))
            assert rel(got, lg) <= TOL, (rcfg.kv_cache_dtype, t)
            assert rel(got, full[:, t]) <= bound, (rcfg.kv_cache_dtype, t)


def test_vision_decode_per_slot_positions_match_reference():
    """Two slots at their own KV slots (a (B,) ``t``, three apart) and their
    own M-RoPE ids, through the int8 cache, against the reference."""
    ref_cfg, params, model = _pair("qwen2-vl")
    sp, max_len = 9, 24
    inputs = _inputs(ref_cfg, 2, sp, seed=3)
    _, rc = _ref_prefill_and_caches(ref_cfg, params, inputs, sp, max_len)
    _, caches = model.prefill(**_port(inputs))
    caches = model.prepare_decode_caches(caches, max_len)
    assert caches[0].k.dtype == torch.int8
    step = jax.jit(lambda p, tk, c, t, mp: ref_model.decode_step(p, tk, c, t, ref_cfg, mrope_positions=mp))
    toks = np.random.default_rng(4).integers(4, ref_cfg.vocab_size, (2, 6))
    t = np.array([sp, sp + 3])
    ids = np.array([sp - SIDE, sp - SIDE + 5])  # each slot's next text id
    for i in range(6):
        mp = np.ascontiguousarray(np.broadcast_to(ids[:, None, None], (2, 3, 1))).astype(np.int32)
        lg, rc = step(params, jnp.asarray(toks[:, i]), rc, jnp.asarray(t), jnp.asarray(mp))
        got, caches = model.decode_step(torch.from_numpy(toks[:, i]), caches, torch.from_numpy(t),
                                        mrope_positions=torch.from_numpy(mp))
        assert rel(got, lg) <= TOL, i
        t, ids = t + 1, ids + 1


def test_mrope_ids_equal_to_the_positions_give_standard_rope():
    """Text alone: M-RoPE ids equal to the positions in all three streams
    rotate as standard RoPE (``tests/test_layers.py``'s check, here through
    the whole model), and no ids at all is standard RoPE too."""
    _, _, model = _pair("qwen2-vl")
    toks = torch.from_numpy(np.random.default_rng(5).integers(4, 512, (2, 20)))
    ids = torch.arange(20).expand(2, 3, 20)
    with torch.no_grad():
        torch.testing.assert_close(model.logits_fn(toks, mrope_positions=ids), model.logits_fn(toks),
                                   rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def test_engine_serves_vision_config_as_text_as_the_reference():
    """The reference's engine prefills ``{"tokens": prompts}``: qwen2-vl is
    served as text, with standard RoPE and its int8 cache.  Greedy
    ``Engine.generate`` and a session with a request inserted after 3 steps
    emit the reference's tokens."""
    ref_cfg, params, model = _pair("qwen2-vl")
    prompts = np.random.default_rng(1).integers(4, 512, (2, 10))
    ref_eng = RefEngine(ref_cfg, params, RefServeConfig(max_new=12, eos_id=-1))
    whole = np.asarray(ref_eng.generate(jnp.asarray(prompts)))
    ref_sess = RefSession(ref_eng, slots=2, max_len=30)
    a = ref_sess.submit(jnp.asarray(prompts[0]))
    ref_sess.run(3)
    b = ref_sess.submit(jnp.asarray(prompts[1]))
    ref_sess.run(11)
    eng = Engine(model, ServeConfig(max_new=12, eos_id=-1))
    np.testing.assert_array_equal(eng.generate(prompts).numpy(), whole)
    sess = ServeSession(eng, slots=2, max_len=30)
    sa = sess.submit(prompts[0])
    sess.run(3)
    sb = sess.submit(prompts[1])
    sess.run(11)
    assert sess.output(sa) == ref_sess.output(a) and sess.output(sb) == ref_sess.output(b)
    assert sess.state.caches[0].k.dtype == torch.int8


def test_audio_config_is_refused_by_the_engine_and_the_launchers():
    """The engine prefills token prompts, which an audio model does not
    take (the reference's fails on the missing ``frame_embeds``); the serve
    and train launchers refuse the arch before building a model."""
    _, _, model = _pair("musicgen")
    eng = Engine(model, ServeConfig(max_new=2))
    with pytest.raises(ValueError, match="frame embeddings"):
        eng.prefill(np.zeros((1, 4), np.int64), max_len=8, generator=eng.generator(0))
    with pytest.raises(ValueError, match="frame embeddings"):
        eng.generate(np.zeros((1, 4), np.int64))
    with pytest.raises(ValueError, match="frame embeddings"):
        launch_serve.main(["--arch", "musicgen-large", "--reduced", "--batch", "1", "--prompt-len", "4",
                           "--max-new", "2", "--device", "cpu"])
    with pytest.raises(ValueError, match="frame embeddings"):
        launch_train.main(["--arch", "musicgen-large", "--reduced", "--steps", "1", "--device", "cpu"])


def test_launch_serve_vision_config_on_the_cpu(capsys):
    rows = launch_serve.main(["--arch", "qwen2-vl-72b", "--reduced", "--batch", "2", "--prompt-len", "8,12",
                              "--max-new", "4", "--warmup", "0", "--device", "cpu"])
    assert [r["prompt_len"] for r in rows] == [8, 12]
    assert "device: cpu" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def _frontend_batch(cfg, step, b, s):
    """``make_batch``'s targets and loss mask with the inputs the reference's
    ``tests/test_models_smoke.py`` builds for the config."""
    batch = token_batch(cfg, step, b, s)
    inputs = _inputs(cfg, b, s, seed=10 + step)
    if cfg.frontend == "audio":
        del batch["tokens"]
    else:
        inputs["tokens"] = batch["tokens"]
    return {**batch, **inputs}


@pytest.mark.parametrize("name", list(ARCHS))
def test_loss_and_adamw_steps_match_reference(name):
    """``loss_fn`` over the frontends' batch keys and two AdamW steps, each
    from the reference's state before it.  S = 24 covers the reduced
    filter's 16 taps: a tap past the sequence gets only the FFT's rounding
    noise as its gradient, which Adam's first step turns into an update of
    full size on either side."""
    ref_cfg, cfg = _cfgs(name)
    check_training(ref_cfg, cfg, b=2, s=24, batch_of=_frontend_batch)
