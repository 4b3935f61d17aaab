"""An open loop of prefill requests through the port's serving engine.

Requests arrive on a fixed schedule (:mod:`portbench.traffic`: ``rate_per_s``,
Poisson-like gaps, the same schedule for every seed) whether or not the
ones before them have finished; the engine serves them one at a time, in
arrival order.  Each is ``repro_torch.serving.engine.Engine.prefill`` of one
prompt (batch 1, the caches laid out for one more position), then its first
token read back on the host.  Its time to first token runs from its arrival
to that read (the queueing included); its service time from the start of
its prefill to that read; its enqueue time from the start of its prefill to
the return of ``Engine.prefill``.  The prompts are made ahead on the
device; the window closes at ``--seconds`` (no arrival after it) and ends
when every request that arrived in it has returned its token.

The weights are made from the seed on the device
(:func:`portbench.reference.danube.make_weights`) and handed to the
program (``DecoderLM`` built on the meta device, the tensors assigned as
its parameters) and, after the window, to the float32 reference.  For a
sample of the prompts drawn from the seed (the longest among them), what
the timed ``Engine.prefill`` computed is kept: the logits of
``DecoderLM.prefill`` and every block's mixer and MLP output at every
position (forward hooks, put on for those requests only).  Both are
compared with the reference's.
"""

from __future__ import annotations

import contextlib
import random
import time

from portbench import compare, spans, traffic as traffic_lib
from portbench.harness import Record
from portbench.reference import danube as ref
from portbench.trace import Tracer

#: The configuration file's keys → ``repro_torch.configs.base.ModelConfig``'s fields.
MODEL_FIELDS = {
    "num_hidden_layers": "num_layers",
    "hidden_size": "d_model",
    "num_attention_heads": "num_heads",
    "num_key_value_heads": "num_kv_heads",
    "intermediate_size": "d_ff",
    "vocab_size": "vocab_size",
    "hidden_act": "act",
    "rms_norm_eps": "norm_eps",
    "tie_word_embeddings": "tie_embeddings",
    "sliding_window": "sliding_window",
    "rope_theta": "rope_theta",
    "use_spectral_mixer": "use_spectral_mixer",
    "spectral_filter_len": "spectral_filter_len",
    "spectral_decode_mode": "spectral_decode_mode",
    "param_dtype": "param_dtype",
    "compute_dtype": "compute_dtype",
    "attn_chunk": "attn_chunk",
    "attn_chunk_threshold": "attn_chunk_threshold",
    "kv_cache_dtype": "kv_cache_dtype",
}


def model_config(cfg: dict):
    from repro_torch.configs.base import ModelConfig

    if cfg["embed_scale"] != "sqrt_hidden_size" or cfg["tie_word_embeddings"]:
        raise ValueError("the port's decoder scales the embedding by sqrt(hidden_size) and unties the head")
    return ModelConfig(name=cfg["name"], family="dense", **{f: cfg[k] for k, f in MODEL_FIELDS.items()})


def check_sample(prompts: list, count: int, seed: int) -> list:
    """The prompts compared: the longest, and ``count − 1`` others drawn from the seed."""
    longest = max(range(len(prompts)), key=lambda p: prompts[p].shape[1])
    rest = [p for p in range(len(prompts)) if p != longest]
    return [longest] + random.Random(seed).sample(rest, min(count, len(prompts)) - 1)


def sublayers(model) -> list:
    """(name, module) of each block's mixer and MLP, named as
    :func:`portbench.reference.danube.forward` names their outputs."""
    out = []
    for layer, block in enumerate(model.stack):
        out += [(f"{layer}.mixer", block.mixer), (f"{layer}.mlp", block.mlp)]
    return out


@contextlib.contextmanager
def capture(model, store: dict):
    """Every sub-layer's output of the calls made inside, kept in ``store``
    by name (the tensors the program made; nothing is copied)."""
    handles = []
    for name, module in sublayers(model):
        def hook(_module, _args, out, _name=name):
            store[_name] = (out[0] if isinstance(out, tuple) else out).detach()

        handles.append(module.register_forward_hook(hook))
    try:
        yield store
    finally:
        for h in handles:
            h.remove()


def setup(ctx) -> dict:
    from repro_torch.models.model import DecoderLM
    from repro_torch.serving.engine import Engine, ServeConfig

    cfg = ctx.config
    weights = ref.make_weights(cfg, ctx.seed, ctx.device)
    model = DecoderLM(model_config(cfg), device="meta")
    model.load_state_dict(weights, strict=True, assign=True)
    engine = Engine(model, ServeConfig(max_new=ctx.traffic["new_tokens"], temperature=0.0))
    prompts = traffic_lib.prompts(ctx.traffic, ctx.seed, cfg["vocab_size"], ctx.device)
    longest = max(p.shape[1] for p in prompts)
    state = {"weights": weights, "model": model, "engine": engine, "prompts": prompts, "logits": [],
             "sample": check_sample(prompts, ctx.traffic["check_sample"], ctx.seed)}
    program_prefill = model.prefill

    def prefill(tokens, **kwargs):
        # The served logits, kept as DecoderLM.prefill computed them; the
        # planted faults of the harness's tests act here, where they are made.
        if "half_prompt" in ctx.faults:
            tokens = tokens[:, tokens.shape[1] // 2:]
        logits, caches = program_prefill(tokens, **kwargs)
        if "alter_answer" in ctx.faults and tokens.shape[1] == longest:
            logits = logits.roll(1, dims=-1)
        state["logits"].append(logits)
        return logits, caches

    model.prefill = prefill
    tracer = Tracer(ctx.trace, ctx.device)
    tracer.warm()
    state["tracer"] = tracer
    gen = engine.generator(ctx.seed)
    for p, tokens in enumerate(prompts):  # every prompt once: every shape, plan and kernel warm
        with capture(model, {}) if p in state["sample"] else contextlib.nullcontext():
            engine.prefill(tokens, max_len=tokens.shape[1] + ctx.traffic["new_tokens"], generator=gen).token.item()
    state["logits"].clear()
    state["generator"] = gen
    return state


def span_targets(model) -> list:
    """A range around each mixer's forward: ``pb.attn`` or ``pb.spectral``."""
    out = []
    for block in model.stack:
        if block.kind == "spectral":
            out.append((block.mixer, "forward", "spectral"))
        elif block.kind in ("attn", "attn_local"):
            out.append((block.mixer, "forward", "attn"))
    return out


def window(state: dict, ctx) -> Record:
    engine, prompts, gen, tracer = state["engine"], state["prompts"], state["generator"], state["tracer"]
    traced, new, sample = ctx.trace, ctx.traffic["new_tokens"], state["sample"]
    gaps = traffic_lib.gaps(ctx.traffic, ctx.seed)
    requests, served = [], {}
    issued = 0
    with tracer.window(ctx.seconds, *ctx.traffic["trace_slice"]), \
            spans.ranges(span_targets(engine.model), traced):
        t0 = time.perf_counter()
        deadline = t0 + ctx.seconds
        while True:
            if tracer.due():
                tracer.toggle()
            t_arrival = t0 + traffic_lib.arrival(gaps, issued)
            if t_arrival >= deadline:
                break
            wait = t_arrival - time.perf_counter()
            if wait > 0:
                with spans.span("arrival_wait", traced):
                    time.sleep(wait)
                continue  # the slice may be due before it is served
            p = issued % len(prompts)
            tokens = prompts[p]
            issued += 1
            outputs = {}
            t_start = time.perf_counter()
            with spans.span("request", traced), \
                    (capture(engine.model, outputs) if p in sample else contextlib.nullcontext()):
                with spans.span("prefill", traced):
                    res = engine.prefill(tokens, max_len=tokens.shape[1] + new, generator=gen)
                t_enqueued = time.perf_counter()
                with spans.span("readback", traced):
                    token = int(res.token.item())
            t_done = time.perf_counter()
            logits = state["logits"].pop()
            if p in sample:
                served[p] = (logits, token, outputs)
            requests.append({"prompt": p, "tokens": tokens.shape[1], "ttft_ms": (t_done - t_arrival) * 1e3,
                             "service_ms": (t_done - t_start) * 1e3, "enqueue_ms": (t_enqueued - t_start) * 1e3,
                             "in_slice": tracer.active})
        tracer.finish()
        window_s = time.perf_counter() - t0
    state["served"] = served
    ctx.details["service_ms_mean"] = sum(r["service_ms"] for r in requests) / max(len(requests), 1)
    return Record(config=ctx.config, traffic=ctx.traffic, window_s=window_s, requests=requests, attempted=issued,
                  slice_s=tracer.slice_s, trace=tracer.trace, launches=tracer.launches.launches)


def layer_errs(program: dict) -> tuple:
    """(errors by name, ``each`` callback for :func:`ref.forward`): the row
    error of each sub-layer output against ``program``'s output of the same
    name, the program's rows aligned at the prompt's end."""
    errs = {}

    def each(name, out):
        got = program[name]
        got = got.reshape(-1, got.shape[-1])
        errs[name] = ref.row_err(got, out[out.shape[0] - got.shape[0]:])

    return errs, each


def check(state: dict, record: Record, ctx) -> list:
    """The sample's logits and every sub-layer's output at every position,
    as the window served them, against the float32 reference over the same
    weights and prompt, after the program is released."""
    for key in ("engine", "model", "logits"):
        state.pop(key)
    cfg, prompts, served = ctx.config, state["prompts"], state.pop("served")
    sample = [p for p in state["sample"] if p in served]
    logit_readings, layer_readings, gaps = [], [], []
    for p in sample:
        logits, token, outputs = served.pop(p)
        errs, each = layer_errs(outputs)
        want = ref.forward(state["weights"], cfg, prompts[p][0], each=each)
        del outputs
        logit_readings.append(ref.rel_l2(logits[0], want))
        layer_readings.append(max(errs.values()))
        gaps.append(ref.top_gap(want, token))
    spec = ctx.check_spec
    ctx.details.update({"logit_err": logit_readings, "layer_err": layer_readings, "token_gap": gaps,
                        "sample": sample})
    return [compare.judged(name, ctx.details[name], limit) for name, limit in spec["limits"].items()]


def control(ctx) -> dict:
    """The control's readings, on the weights and prompts of ``ctx.seed``
    over the sample :func:`check` draws: the reference with fp8 matrix
    products (``cast="fp8"``) in the program's place, compared as the
    program is; the token gap is that of the token fp8 puts first.  Also
    the planted far-context fault's (``fault_*``): the reference with each
    attention layer's keys further back than half the prompt left out."""
    cfg = ctx.config
    weights = ref.make_weights(cfg, ctx.seed, ctx.device)
    prompts = traffic_lib.prompts(ctx.traffic, ctx.seed, cfg["vocab_size"], ctx.device)
    out = {"logit_err": [], "layer_err": [], "token_gap": [], "fault_logit_err": [], "fault_layer_err": []}
    sample = check_sample(prompts, ctx.traffic["check_sample"], ctx.seed)
    for p in sample:
        tokens = prompts[p][0]
        kept = {}
        want = ref.forward(weights, cfg, tokens, each=kept.__setitem__)
        for prefix, kwargs in (("", {"cast": "fp8"}), ("fault_", {"context": tokens.shape[0] // 2})):
            errs, each = layer_errs(kept)
            got = ref.forward(weights, cfg, tokens, each=each, **kwargs)
            out[prefix + "logit_err"].append(ref.rel_l2(got, want))
            out[prefix + "layer_err"].append(max(errs.values()))
            if not prefix:
                out["token_gap"].append(ref.top_gap(want, int(got.argmax())))
    out["sample"] = sample
    return out
