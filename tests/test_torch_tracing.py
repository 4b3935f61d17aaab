"""The port's own spans and counters (``repro_torch.runtime.tracing``):
recorded exactly while a profiler records, nested as the layers call each
other, one request id a prefill, the weight casts and plane copies counted
where they are made, a record per profiler session; and the kernel
wrappers as the benchmark finds them."""

import dataclasses
import gc
import importlib
import os
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import base
from repro_torch.configs.reduce import make_reduced
from repro_torch.core import fft as fft_lib
from repro_torch.models.model import DecoderLM
from repro_torch.runtime import tracing
from repro_torch.serving.engine import Engine, ServeConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: Every span a spectral hybrid's prefill opens on the CPU route (the
#: plain kernel versions open none).
PREFILL_SPANS = {
    "serve.prefill", "serve.decode_layout", "serve.sample", "model.prefill", "block.attn",
    "block.spectral", "block.mlp", "spectral.decode_state", "conv.fft_conv", "fft.plan", "fft.call",
    "fft.apply_planes", "exec.plan",
}
#: (span, a span it lies inside).
NESTED = [
    ("model.prefill", "serve.prefill"), ("serve.decode_layout", "serve.prefill"),
    ("serve.sample", "serve.prefill"), ("block.attn", "model.prefill"), ("block.spectral", "model.prefill"),
    ("block.mlp", "model.prefill"), ("spectral.decode_state", "block.spectral"),
    ("conv.fft_conv", "block.spectral"), ("fft.call", "block.spectral"), ("fft.apply_planes", "fft.call"),
    ("exec.plan", "fft.apply_planes"),
]


@pytest.fixture(scope="module")
def engine():
    cfg = make_reduced(dataclasses.replace(base.get_config("h2o-danube-1.8b"), use_spectral_mixer=True))
    assert cfg.pattern() == ("spectral", "attn") * 2
    assert (cfg.param_dtype, cfg.compute_dtype) == ("float32", "bfloat16")
    model = DecoderLM(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    return Engine(model, ServeConfig(max_new=2))


@pytest.fixture(scope="module")
def tokens():
    return torch.randint(4, 500, (1, 21), generator=torch.Generator().manual_seed(5))


def prefill(engine, tokens):
    return engine.prefill(tokens, max_len=tokens.shape[1] + 2, generator=engine.generator(0))


def traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, tracing.record(), prof


def ancestors(rec, s):
    at = s.parent
    while at >= 0:
        yield rec.spans[at]
        at = rec.spans[at].parent


def test_off_records_nothing_and_computes_what_on_computes(engine, tokens):
    traced(lambda: prefill(engine, tokens))
    on = traced(lambda: prefill(engine, tokens))[0]
    assert not tracing.enabled()
    before = tracing.record()
    off = prefill(engine, tokens)
    assert tracing.record() == before  # nothing recorded off
    assert torch.equal(off.token, on.token) and torch.equal(off.length, on.length)
    for a, b in zip(off.caches, on.caches, strict=True):
        for x, y in zip(a, b, strict=True):
            assert (torch.equal(x, y) if torch.is_tensor(x) else x == y)
    assert tracing.span("fft.call") is tracing.span("fft.call")  # the name's one null context


def test_a_prefill_opens_the_layers_spans_nested_under_one_request(engine, tokens):
    _, rec, prof = traced(lambda: prefill(engine, tokens))
    assert rec.dropped == 0 and all(s.end_ns >= s.start_ns for s in rec.spans)
    names = {s.name for s in rec.spans}
    assert names == PREFILL_SPANS
    ranges = {e.name for e in prof.events() if e.name.startswith(tracing.PREFIX)}
    assert ranges == {tracing.PREFIX + n for n in PREFILL_SPANS}
    assert not any(e.name.startswith(("pb.", "cu")) for e in prof.events() if e.name.startswith("repro"))
    for inner, outer in NESTED:
        spans = [s for s in rec.spans if s.name == inner]
        assert spans and all(outer in {a.name for a in ancestors(rec, s)} for s in spans), (inner, outer)
    (root,) = [s for s in rec.spans if s.name == "serve.prefill"]
    assert root.parent == -1 and root.request_id is not None
    assert {s.request_id for s in rec.spans} == {root.request_id}
    cfg = engine.model.cfg
    assert sum(s.name == "block.attn" for s in rec.spans) == cfg.pattern().count("attn")
    assert sum(s.name == "block.spectral" for s in rec.spans) == cfg.pattern().count("spectral")
    assert sum(s.name == "block.mlp" for s in rec.spans) == len(cfg.pattern())


def test_requests_take_new_ids(engine, tokens):
    _, rec, _ = traced(lambda: [prefill(engine, tokens) for _ in range(3)])
    roots = [s.request_id for s in rec.spans if s.name == "serve.prefill"]
    assert len(roots) == 3 and len(set(roots)) == 3
    assert len({s.request_id for s in rec.spans}) == 3


def test_the_five_host_parts_partition_the_request(engine, tokens):
    """Attention, spectral less its decode state, MLP, decode-state build and
    the rest sum to serve.prefill; each is a share of it, and the self times
    of every span sum to it too."""
    _, rec, _ = traced(lambda: prefill(engine, tokens))
    inside = tracing.inclusive_ms(rec, under="serve.prefill")
    total = tracing.inclusive_ms(rec)["serve.prefill"]
    states = tracing.inclusive_ms(rec, under="block.spectral")["spectral.decode_state"]
    parts = [inside["block.attn"], inside["block.spectral"] - states, inside["block.mlp"],
             inside["serve.decode_layout"] + inside["spectral.decode_state"]]
    glue = total - sum(parts)
    assert all(p > 0 for p in parts) and 0 < glue < total
    assert sum(tracing.self_ms(rec).values()) == pytest.approx(total, rel=1e-9)
    assert inside.get("serve.prefill") is None  # inclusive counts the outer span only


def test_weight_casts_are_the_models_matrices(engine, tokens):
    """Every matrix of the blocks is cast to bf16 once at its use (the MLP's
    three, attention's four, the spectral mixer's three); the embedding
    gathers rows and the head computes in float32, casting nothing."""
    _, rec, _ = traced(lambda: prefill(engine, tokens))
    mats = [p for name, p in engine.model.named_parameters()
            if name.startswith("stack.") and p.dim() >= 2 and not name.endswith(".filt")]
    assert len(mats) == 2 * 3 + 2 * 4 + 4 * 3
    assert rec.counters["weight_cast.count"] == len(mats)
    assert rec.counters["weight_cast.bytes"] == sum(p.numel() * p.element_size() for p in mats)


def test_a_cropped_planned_fft_counts_its_copy_and_a_contiguous_one_none():
    planned = fft_lib.plan(fft_lib.FFTSpec(n=64, kind="fft", axis=-2), device="cpu")
    xr, xi = torch.randn(2, 64, 96), torch.randn(2, 64, 96)
    want = planned.apply_planes(xr[..., :40].contiguous(), xi[..., :40].contiguous())
    got, rec, _ = traced(lambda: planned.apply_planes(xr[..., :40], xi[..., :40]))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert rec.counters == {"plane_copy.count": 2, "plane_copy.bytes": 2 * 2 * 64 * 40 * 4}
    _, rec, _ = traced(lambda: planned.apply_planes(xr, xi))
    assert "plane_copy.bytes" not in rec.counters and {s.name for s in rec.spans} == {"fft.apply_planes", "exec.plan"}
    _, rec, _ = traced(lambda: fft_lib.plan(fft_lib.FFTSpec(n=64), device="cpu")(torch.randn(3, 64, dtype=torch.complex64)))
    # the real and imaginary views made contiguous, the complex result joined
    assert rec.counters == {"plane_copy.count": 3, "plane_copy.bytes": 2 * 3 * 64 * 4 + 3 * 64 * 8}


def test_the_record_resets_per_profiler_session(engine, tokens):
    traced(lambda: [prefill(engine, tokens) for _ in range(2)])
    _, rec, _ = traced(lambda: prefill(engine, tokens))
    assert sum(s.name == "serve.prefill" for s in rec.spans) == 1
    with profile(activities=[ProfilerActivity.CPU]):
        tracing.count("weight_cast.count", 5)
    assert tracing.record().counters == {"weight_cast.count": 5} and not tracing.record().spans
    tracing.count("weight_cast.count")  # off: not counted
    assert tracing.record().counters == {"weight_cast.count": 5}


def test_a_full_record_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(tracing, "MAX_SPANS", 3)
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(5):
            with tracing.span("fft.call"):
                pass
    rec = tracing.record()
    assert len(rec.spans) == 3 and rec.dropped == 2


def test_a_long_record_triggers_no_garbage_collection():
    """A span leaves no object the collector tracks behind it, so recording
    adds no collection to the work it times."""
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("fft.call"):
            pass
        gc.collect()
        before = gc.get_stats()[0]["collections"]
        for _ in range(5000):
            with tracing.span("fft.call"), tracing.span("kernel.fft4step"):
                pass
        after = gc.get_stats()[0]["collections"]
    assert len(tracing.record().spans) == 10001 and after == before


def test_the_decorator_form_spans_each_call():
    calls = tracing.span("conv.fft_conv")(lambda x: x + 1)
    assert calls(1) == 2
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("fft.call"):
            calls(2)
    rec = tracing.record()
    assert [s.name for s in rec.spans] == ["fft.call", "conv.fft_conv"] and rec.spans[1].parent == 0


#: The public wrappers of the kernel modules (module, function).
WRAPPERS = [
    ("dft_matmul", "dft_matmul_call"), ("fft4step", "fft4step_call"), ("pencil", "cols_pass_call"),
    ("pencil", "cols_natural_call"), ("pencil", "rows_natural_call"), ("pencil", "rfft_recomb_call"),
    ("pencil", "irfft_recomb_call"), ("bluestein", "bluestein_fwd_call"), ("bluestein", "bluestein_inv_call"),
    ("bluestein", "bluestein_elem_call"),
]


def test_a_span_directly_inside_its_own_name_is_not_recorded():
    """execute_plan walking its program through execute_program: one
    exec.plan span; a span of another name between two of one name keeps
    both."""
    planned = fft_lib.plan(fft_lib.FFTSpec(n=64), device="cpu")
    xr, xi = torch.randn(3, 64), torch.randn(3, 64)
    _, rec, _ = traced(lambda: planned.apply_planes(xr, xi))
    assert [s.name for s in rec.spans] == ["fft.apply_planes", "exec.plan"]
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("fft.call"), tracing.span("conv.fft_conv"), tracing.span("fft.call"):
            pass
    rec = tracing.record()
    assert [(s.name, s.parent) for s in rec.spans] == [("fft.call", -1), ("conv.fft_conv", 0), ("fft.call", 1)]
    assert tracing.inclusive_ms(rec).keys() == {"fft.call", "conv.fft_conv"}


def test_every_kernel_wrapper_keeps_its_module_and_the_benchmark_finds_it():
    for mod, name in WRAPPERS:
        fn = getattr(importlib.import_module(f"repro_torch.kernels.{mod}"), name)
        assert fn.__module__ == f"repro_torch.kernels.{mod}" and fn.__name__ == name
    sys.path.insert(0, REPO)
    try:
        from portbench import spans
    finally:
        sys.path.remove(REPO)
    found = sorted((m.__name__.rsplit(".", 1)[1], n) for m, n in spans.kernel_functions())
    assert found == sorted(WRAPPERS)
