"""Serving (``repro_torch.serving``, ``launch.serve``) against the reference.

On the reduced spectral hybrid (``make_reduced`` of h2o-danube-1.8b with
``use_spectral_mixer``: ``("spectral", "attn") × 2``, d_model 64) at float32
compute, the reference's parameters loaded into the port: greedy
``Engine.generate`` and ``ServeSession`` (with a request inserted into a
running batch) emit the reference's tokens exactly.  Sampling cannot share
JAX's random stream, so it is held by its support and its distribution, as
``tests/test_serving.py`` holds the reference's.  Then the engine's own
invariants: EOS freezes a slot bit for bit, stream equals ring, a warm
session plans nothing, and the session's deadlines, queue, retries and
health, and the launcher on the CPU route.  The MoE configs and the
recurrent ones (reduced zamba2-2.7b and xlstm-125m: an inserted request
keeps its prefill's state, a done slot's recurrent states stay bit for
bit) are held the same way.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.configs.reduce import make_reduced as ref_make_reduced
from repro.models import model as ref_model
from repro.serving.engine import Engine as RefEngine
from repro.serving.engine import ServeConfig as RefServeConfig
from repro.serving.spectral_serve import ServeSession as RefSession
from repro_torch.configs import base
from repro_torch.configs.reduce import make_reduced
from repro_torch.core import faults
from repro_torch.core import fft as fft_lib
from repro_torch.launch import serve as launch_serve
from repro_torch.models.model import DecoderLM
from repro_torch.models.layers.attention import KVCache as attn_kv
from repro_torch.serving.engine import RECURRENT_STATES, DecodeState, Engine, ServeConfig
from repro_torch.serving.sampling import sample
from repro_torch.serving.spectral_serve import ServeSession, sweep_once
from repro_torch.utils.params import load_reference_model


@pytest.fixture(scope="module")
def ref_side():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_FFT_TUNE", "off")
        cfg = ref_make_reduced(dataclasses.replace(ref_base.get_config("h2o-danube-1.8b"), use_spectral_mixer=True))
        cfg = dataclasses.replace(cfg, compute_dtype="float32")
        params, _ = ref_model.init_unzipped(jax.random.PRNGKey(0), cfg)
        yield cfg, params


@pytest.fixture(scope="module")
def model(ref_side):
    cfg = make_reduced(dataclasses.replace(base.get_config("h2o-danube-1.8b"), use_spectral_mixer=True))
    cfg = dataclasses.replace(cfg, compute_dtype="float32")
    assert cfg.pattern() == ("spectral", "attn") * 2
    return load_reference_model(DecoderLM(cfg, device="cpu"), jax.tree.map(np.asarray, ref_side[1]))


@pytest.fixture(scope="module")
def prompts():
    return np.random.default_rng(1).integers(4, 512, (2, 10))


def _engine(model, max_new=12, eos_id=-1, **cfg_overrides):
    if cfg_overrides:
        twin = DecoderLM(dataclasses.replace(model.cfg, **cfg_overrides), device="cpu")
        twin.load_state_dict(model.state_dict())
        model = twin
    return Engine(model, ServeConfig(max_new=max_new, eos_id=eos_id))


# -- against the reference ----------------------------------------------------


@pytest.fixture(scope="module")
def ref_outputs(ref_side, prompts):
    """The reference's greedy tokens: whole-batch generate, and a session
    where the second request joins after 3 steps (mid-chunk: C = 8)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_FFT_TUNE", "off")
        cfg, params = ref_side
        eng = RefEngine(cfg, params, RefServeConfig(max_new=12, eos_id=-1))
        whole = np.asarray(eng.generate(jnp.asarray(prompts)))
        sess = RefSession(eng, slots=2, max_len=30)
        a = sess.submit(jnp.asarray(prompts[0]))
        sess.run(3)
        b = sess.submit(jnp.asarray(prompts[1]))
        sess.run(11)
        yield whole, sess.output(a), sess.output(b)


def test_generate_matches_reference(model, prompts, ref_outputs):
    out = _engine(model).generate(prompts)
    assert out.shape == (2, 12) and out.dtype == torch.int64
    np.testing.assert_array_equal(out.numpy(), ref_outputs[0])


def test_session_with_insert_matches_reference(model, prompts, ref_outputs):
    sess = ServeSession(_engine(model), slots=2, max_len=30)
    a = sess.submit(prompts[0])
    sess.run(3)  # slot 0 alone; the global stream phase advances
    b = sess.submit(prompts[1])  # joins mid-chunk: re-phased
    sess.run(11)
    assert sess.output(a) == ref_outputs[1]
    assert sess.output(b) == ref_outputs[2]
    # ... and each is what it would be alone.
    assert sess.output(a)[:12] == ref_outputs[0][0].tolist()
    assert sess.output(b)[:12] == ref_outputs[0][1].tolist()


@pytest.mark.parametrize("arch,spectral", [("deepseek-moe-16b", True), ("arctic-480b", False)],
                         ids=["deepseek-moe-16b+spectral", "arctic-480b"])
def test_moe_session_with_insert_matches_reference(arch, spectral, prompts):
    """The reduced MoE configs at float32 compute, the reference's
    parameters: deepseek-moe-16b with the spectral flag (``("spectral",
    "moe") × 2``) and arctic-480b (the dense residual, bf16 parameters, int8
    KV); greedy ``Engine.generate`` and a session with a request inserted
    after 3 steps emit the reference's tokens."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_FFT_TUNE", "off")
        changes = dict(compute_dtype="float32", param_dtype="bfloat16" if arch == "arctic-480b" else "float32")
        ref_cfg = dataclasses.replace(
            ref_make_reduced(dataclasses.replace(ref_base.get_config(arch), use_spectral_mixer=spectral)), **changes)
        cfg = dataclasses.replace(
            make_reduced(dataclasses.replace(base.get_config(arch), use_spectral_mixer=spectral)), **changes)
        assert dataclasses.asdict(ref_cfg) == dataclasses.asdict(cfg) and "moe" in cfg.pattern()
        params, _ = ref_model.init_unzipped(jax.random.PRNGKey(0), ref_cfg)
        ref_eng = RefEngine(ref_cfg, params, RefServeConfig(max_new=12, eos_id=-1))
        whole = np.asarray(ref_eng.generate(jnp.asarray(prompts)))
        ref_sess = RefSession(ref_eng, slots=2, max_len=30)
        a = ref_sess.submit(jnp.asarray(prompts[0]))
        ref_sess.run(3)
        b = ref_sess.submit(jnp.asarray(prompts[1]))
        ref_sess.run(11)
        port = load_reference_model(DecoderLM(cfg, device="cpu"), jax.tree.map(np.asarray, params))
        eng = Engine(port, ServeConfig(max_new=12, eos_id=-1))
        np.testing.assert_array_equal(eng.generate(prompts).numpy(), whole)
        sess = ServeSession(eng, slots=2, max_len=30)
        sa = sess.submit(prompts[0])
        sess.run(3)
        sb = sess.submit(prompts[1])
        sess.run(11)
        assert sess.output(sa) == ref_sess.output(a) and sess.output(sb) == ref_sess.output(b)
        assert sess.state.caches[-1].k.dtype == (torch.int8 if arch == "arctic-480b" else torch.float32)


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "xlstm-125m"])
def test_recurrent_session_with_insert_matches_reference(arch):
    """The reduced recurrent configs at float32 compute, the reference's
    parameters: zamba2-2.7b (``(mamba2 × 6, shared_attn) × 2``: SSM states
    and the shared block's KV caches) and xlstm-125m (``(mlstm, mlstm,
    slstm) × 2``).  Prompts of 16 tokens (two chunks of 8).  Greedy
    ``Engine.generate`` and a session with a request inserted after 3 steps
    emit the reference's tokens, and the inserted slot's recurrent states
    are its prefill's, row for row (the other slot's untouched)."""
    prompts = np.random.default_rng(2).integers(4, 512, (2, 16))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_FFT_TUNE", "off")
        ref_cfg = dataclasses.replace(ref_make_reduced(ref_base.get_config(arch)), compute_dtype="float32")
        cfg = dataclasses.replace(make_reduced(base.get_config(arch)), compute_dtype="float32")
        assert dataclasses.asdict(ref_cfg) == dataclasses.asdict(cfg)
        params, _ = ref_model.init_unzipped(jax.random.PRNGKey(0), ref_cfg)
        ref_eng = RefEngine(ref_cfg, params, RefServeConfig(max_new=12, eos_id=-1))
        whole = np.asarray(ref_eng.generate(jnp.asarray(prompts)))
        ref_sess = RefSession(ref_eng, slots=2, max_len=30)
        a = ref_sess.submit(jnp.asarray(prompts[0]))
        ref_sess.run(3)
        b = ref_sess.submit(jnp.asarray(prompts[1]))
        ref_sess.run(11)
    port = load_reference_model(DecoderLM(cfg, device="cpu"), jax.tree.map(np.asarray, params))
    eng = Engine(port, ServeConfig(max_new=12, eos_id=-1))
    np.testing.assert_array_equal(eng.generate(prompts).numpy(), whole)
    sess = ServeSession(eng, slots=2, max_len=30)
    sa = sess.submit(prompts[0])
    sess.run(3)
    running = sess.state.caches
    pres = eng.prefill(prompts[1:], max_len=30, generator=eng.generator(0))
    sb = sess.submit(prompts[1])
    recurrent = 0
    for live, before, new in zip(sess.state.caches, running, pres.caches, strict=True):
        assert type(live) is type(new)
        if isinstance(live, RECURRENT_STATES):
            recurrent += 1
            for name in live._fields:
                assert torch.equal(getattr(live, name)[1], getattr(new, name)[0].to(getattr(live, name).dtype))
                assert torch.equal(getattr(live, name)[0], getattr(before, name)[0])
    assert recurrent == (12 if arch == "zamba2-2.7b" else 6)
    sess.run(11)
    assert sess.output(sa) == ref_sess.output(a) and sess.output(sb) == ref_sess.output(b)


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "xlstm-125m"])
def test_done_slot_recurrent_states_stay_bit_for_bit(arch):
    """Once a slot emits EOS, every field of its ``SSMCache``, ``MLSTMCache``
    and ``SLSTMCache`` (and its KV rows) stays bit for bit while the other
    slot decodes on; every field of the live slot moves."""
    cfg = dataclasses.replace(make_reduced(base.get_config(arch)), compute_dtype="float32")
    model = DecoderLM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    prompts = np.random.default_rng(3).integers(4, 512, (2, 8))
    ref = Engine(model, ServeConfig(max_new=10, eos_id=-1)).generate(prompts).numpy()
    eos = int(ref[0, 3])  # row 0 finishes at its 4th token
    assert eos not in ref[1, :10].tolist()
    eng = Engine(model, ServeConfig(max_new=10, eos_id=eos))
    gen = eng.generator(0)
    pres = eng.prefill(prompts, max_len=24, generator=gen)
    state = DecodeState(pres.caches, pres.token, pres.length, pres.token == eos, gen)
    state, _ = eng.decode(state, 5)
    assert bool(state.done[0]) and not bool(state.done[1])
    frozen, toks = eng.decode(state, 6)
    assert (toks[0] == eos).all()
    kinds = set()
    for before, after in zip(state.caches, frozen.caches):
        kinds.add(type(after).__name__)
        for a, b in zip(before, after):
            if torch.is_tensor(a):
                assert torch.equal(a[0], b[0])
                assert isinstance(after, attn_kv) or not torch.equal(a[1], b[1])
    assert kinds == ({"SSMCache", "KVCache"} if arch == "zamba2-2.7b" else {"MLSTMCache", "SLSTMCache"})


def test_session_matches_whole_batch_generate(model, prompts):
    eng = _engine(model, max_new=8)
    ref = eng.generate(prompts).numpy()
    sess = ServeSession(eng, slots=2, max_len=18)
    s0, s1 = sess.submit(prompts[0]), sess.submit(prompts[1])
    sess.run(7)
    assert sess.output(s0) == ref[0].tolist() and sess.output(s1) == ref[1].tolist()


def test_insert_of_a_plain_window_model_keeps_the_prompt():
    """The plain reduced h2o-danube (attn_local, window 8) served with
    max_len below the window: the inserted request's ring holds its prompt
    and the session decodes as ``generate`` does."""
    cfg = dataclasses.replace(make_reduced(base.get_config("h2o-danube-1.8b")), compute_dtype="float32")
    eng = Engine(DecoderLM(cfg, device="cpu", generator=torch.Generator().manual_seed(0)),
                 ServeConfig(max_new=4, eos_id=-1))
    prompt = np.random.default_rng(1).integers(4, 512, (1, 3))
    ref = eng.generate(prompt).numpy()
    sess = ServeSession(eng, slots=1, max_len=7)
    sess.submit(prompt[0])
    assert sess.state.caches[0].k.shape[1] == 7 and sess.state.caches[0].k.abs().max() > 0
    sess.run(3)
    assert sess.output(0) == ref[0].tolist()


# -- sampling -------------------------------------------------------------------


def _draws(logits, n, seed, **kw):
    rows = torch.log(torch.tensor(logits))[None].expand(n, -1)
    return sample(rows, temperature=1.0, generator=torch.Generator().manual_seed(seed), **kw).numpy()


def test_top_p_restricts_support_and_matches_distribution():
    """top_p=0.7 over p=[.5,.3,.15,.05] keeps exactly {0,1}; renormalised
    P(0) = .5/.8 = .625.  Seeded frequency check over 4000 draws."""
    counts = np.bincount(_draws([0.5, 0.3, 0.15, 0.05], 4000, 7, top_p=0.7), minlength=4)
    assert counts[2] == 0 and counts[3] == 0, "tokens outside the nucleus sampled"
    assert abs(counts[0] / counts.sum() - 0.625) < 0.05


def test_top_p_keeps_argmax():
    assert (_draws([0.9, 0.05, 0.03, 0.02], 64, 3, top_p=1e-6) == 0).all()


def test_top_k_and_top_p_compose():
    """k filters first, p renormalises over the survivors: k=3 drops token 3;
    within {.4,.3,.2}/.9 the nucleus at .5 keeps {0, 1}."""
    assert set(_draws([0.4, 0.3, 0.2, 0.1], 512, 5, top_k=3, top_p=0.5).tolist()) <= {0, 1}


def test_top_k_support_and_temperature_distribution():
    p = np.array([0.4, 0.3, 0.2, 0.1])
    counts = np.bincount(_draws(p.tolist(), 8000, 11, top_k=2), minlength=4)
    assert counts[2] == counts[3] == 0
    assert abs(counts[0] / counts.sum() - 0.4 / 0.7) < 0.03
    # temperature 2 flattens softmax(log p) to softmax(log p / 2)
    rows = torch.log(torch.tensor(p, dtype=torch.float32))[None].expand(8000, -1)
    got = np.bincount(sample(rows, temperature=2.0, generator=torch.Generator().manual_seed(2)).numpy(),
                      minlength=4) / 8000
    want = np.sqrt(p) / np.sqrt(p).sum()
    assert np.abs(got - want).max() < 0.03


def test_greedy_is_the_first_argmax():
    logits = torch.tensor([[0.0, 2.0, 2.0, 1.0], [5.0, -1.0, 5.0, 0.0]])
    assert sample(logits).tolist() == [1, 0]
    ref = np.asarray(jnp.argmax(jnp.asarray(logits.numpy()), axis=-1))
    assert sample(logits).numpy().tolist() == ref.tolist()


# -- EOS and the batch state ------------------------------------------------------


def test_eos_freezes_slot_bit_for_bit(model, prompts):
    """Once a slot emits EOS every later emission is EOS, the tokens before
    are unchanged, and the slot's cache rows, length and last token stop
    changing while the other slot decodes on (through a stream flush)."""
    ref = _engine(model, max_new=10).generate(prompts).numpy()
    eos = int(ref[0, 3])  # row 0 finishes at its 4th token
    eng = _engine(model, max_new=10, eos_id=eos)
    out = eng.generate(prompts).numpy()
    assert out[0, 3] == eos and (out[0, 4:] == eos).all()
    assert (out[0, :4] == ref[0, :4]).all()

    gen = eng.generator(0)
    pres = eng.prefill(prompts, max_len=40, generator=gen)
    state = DecodeState(pres.caches, pres.token, pres.length, pres.token == eos, gen)
    state, _ = eng.decode(state, 5)  # row 0 is done after step 3
    assert bool(state.done[0]) and not bool(state.done[1])
    snap = [[None if a is None or isinstance(a, int) else a.clone() for a in c] for c in state.caches]
    frozen, toks = eng.decode(state, 10)  # the chunk C = 8 flushes in here
    assert (toks[0] == eos).all() and not (toks[1] == eos).all()
    for before, after in zip(snap, frozen.caches):
        for a, b in zip(before, after):
            if a is not None:
                assert torch.equal(a[0], b[0])
                assert not torch.equal(a[1], b[1])
    assert frozen.lengths[0] == state.lengths[0] and frozen.lengths[1] > state.lengths[1]
    assert frozen.tokens[0] == state.tokens[0]


def test_first_token_eos(model, prompts):
    first = int(_engine(model, max_new=1).generate(prompts)[0, 0])
    out = _engine(model, max_new=6, eos_id=first).generate(prompts)
    assert (out[0] == first).all()


def test_insert_requires_stream_mode(model, prompts):
    eng = _engine(model, spectral_decode_mode="ring")
    pres = eng.prefill(prompts[:1], max_len=18, generator=eng.generator(0))
    with pytest.raises(ValueError, match="stream"):
        eng.insert(eng.init_state(2, 18), pres, 0)


def test_insert_refuses_a_prefill_of_another_length(model, prompts):
    eng = _engine(model)
    pres = eng.prefill(prompts[:1], max_len=24, generator=eng.generator(0))
    with pytest.raises(faults.ServeError, match="cannot insert"):
        eng.insert(eng.init_state(2, 18), pres, 0)
    pres = eng.prefill(prompts[:1], max_len=18, generator=eng.generator(0))
    with pytest.raises(faults.ServeError, match="slot 2"):
        eng.insert(eng.init_state(2, 18), pres, 2)


def test_stream_equals_ring_oracle(model, prompts):
    np.testing.assert_array_equal(_engine(model).generate(prompts).numpy(),
                                  _engine(model, spectral_decode_mode="ring").generate(prompts).numpy())


def test_release_freezes_like_eos(model, prompts):
    eng = _engine(model)
    sess = ServeSession(eng, slots=2, max_len=30)
    sess.submit(prompts[0])
    sess.submit(prompts[1])
    sess.state = eng.release(sess.state, 1)
    toks = sess.engine.decode(sess.state, 3)[1]
    assert (toks[1] == -1).all() and not (toks[0] == -1).any()


def test_zero_new_plans_when_warm(model):
    """After one sweep, a whole prefill + insert + decode pass creates no FFT
    plan: every spectral flush reuses the cached plans."""
    eng = _engine(model)
    sweep_once(eng, batch=2, prompt_len=10, max_new=10, warmup=0)
    fft_lib.clear_plan_log()
    r = sweep_once(eng, batch=2, prompt_len=10, max_new=10, warmup=0)
    assert fft_lib.plan_log() == ()
    assert r["decode_tok_per_s"] is not None and r["batch"] == 2


# -- the session's robustness ---------------------------------------------------


def test_prefill_faults_retry_then_raise_typed(model, prompts):
    sess = ServeSession(_engine(model), slots=2, max_len=32)
    with faults.inject_fault("serve.prefill", times=1):
        slot = sess.submit(prompts[0])
    assert slot == 0 and sess.counts["retries"] == 1 and len(sess.output(slot)) == 1
    sess = ServeSession(_engine(model), slots=1, max_len=32, prefill_retries=1)
    with faults.inject_fault("serve.prefill", times=8):
        with pytest.raises(faults.ServeError) as ei:
            sess.submit(prompts[0])
    assert ei.value.injected


def test_insert_and_generate_faults_raise_typed(model, prompts):
    sess = ServeSession(_engine(model), slots=1, max_len=32)
    with faults.inject_fault("serve.insert"):
        with pytest.raises(faults.ServeError):
            sess.submit(prompts[0])
    sess = ServeSession(_engine(model), slots=1, max_len=32)
    sess.submit(prompts[0])
    with faults.inject_fault("serve.generate"):
        with pytest.raises(faults.ServeError):
            sess.run(2)


def test_queue_backpressure_deadlines_and_health(model, prompts):
    sess = ServeSession(_engine(model), slots=1, max_len=32, queue_cap=1)
    slot = sess.submit(prompts[0])
    ticket = sess.submit(prompts[1])
    assert slot == 0 and ticket < 0
    with pytest.raises(faults.ServeError, match="queue"):
        sess.submit(prompts[0])
    assert sess.counts["rejected"] == 1
    with pytest.raises(faults.ServeError, match="queued"):
        sess.output(ticket)
    h = sess.health()
    assert h["slots"] == 1 and h["live"] == 1 and h["queue_depth"] == 1 and "fault_counters" in h
    sess._deadline[0] = -1.0  # expire the occupant: run() reaps it and drains the queue
    sess.run(2)
    assert sess.counts["expired"] == 1 and len(sess.output(ticket)) == 3
    sess = ServeSession(_engine(model), slots=1, max_len=32, default_deadline_s=0.0)
    sess.submit(prompts[0])
    sess.run(2)
    assert sess.counts["expired"] == 1 and sess.free_slots() == [0]
    with pytest.raises(faults.ServeError, match="max_len"):
        sess.submit(np.arange(40) + 4)


# -- entry points ---------------------------------------------------------------


def test_launch_serve_on_the_cpu(capsys):
    rows = launch_serve.main(["--arch", "h2o-danube-1.8b", "--reduced", "--spectral", "--batch", "2",
                              "--prompt-len", "8,12", "--max-new", "4", "--warmup", "0", "--device", "cpu",
                              "--phase-times"])
    out = capsys.readouterr().out
    assert [r["prompt_len"] for r in rows] == [8, 12]
    assert "prefill" in out and "device: cpu" in out


def test_launch_serve_moe_on_the_cpu(capsys):
    """The reduced deepseek-moe-16b with the spectral flag through the
    launcher."""
    rows = launch_serve.main(["--arch", "deepseek-moe-16b", "--reduced", "--spectral", "--batch", "2",
                              "--prompt-len", "8,12", "--max-new", "4", "--warmup", "0", "--device", "cpu"])
    out = capsys.readouterr().out
    assert [r["prompt_len"] for r in rows] == [8, 12]
    assert "decode=" in out and "device: cpu" in out


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "xlstm-125m"])
def test_launch_serve_recurrent_on_the_cpu(arch, capsys):
    """The reduced recurrent configs through the launcher, prompts of one
    chunk and of two."""
    rows = launch_serve.main(["--arch", arch, "--reduced", "--batch", "2", "--prompt-len", "8,16",
                              "--max-new", "4", "--warmup", "0", "--device", "cpu"])
    out = capsys.readouterr().out
    assert [r["prompt_len"] for r in rows] == [8, 16]
    assert "decode=" in out and "device: cpu" in out


def test_entry_points_without_a_device_need_the_card(monkeypatch, model):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(faults.PlanError, match="no CUDA device"):
        DecoderLM(model.cfg)
    with pytest.raises(faults.PlanError, match="no CUDA device"):
        launch_serve.main(["--arch", "h2o-danube-1.8b", "--reduced", "--max-new", "2"])
