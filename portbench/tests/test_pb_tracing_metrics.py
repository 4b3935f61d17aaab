"""The per-layer metrics read from the program's own spans and counters:
a tiny traced run of each cell on the CPU route reports them, finite; an
untraced run reports none; the prefill's five host parts sum to the mean
``serve.prefill`` span; and a program without the tracing module reads
nothing and raises nothing."""

import math
import sys
import time

import pb_tiny
import pytest

from portbench import common, harness, program

PROGRAM_METRICS = {
    "danube_prefill": ["attn_host_ms.prefill", "spectral_host_ms.prefill", "mlp_host_ms.prefill",
                       "decode_state_host_ms.prefill", "glue_host_ms.prefill", "weight_cast_gb.prefill"],
    "sar_stripmap": ["fft_glue_host_ms.sar", "launch_host_ms.sar", "plane_copy_mb.sar"],
}


def run(cell, trace):
    return harness.run(cell, 2 ** 33 + 11, 1.5 if trace else 0.6, trace, t_start=time.perf_counter(),
                       device="cpu", overrides=pb_tiny.TINY[cell])


def test_every_program_metric_has_an_entry_and_a_reader():
    entries = {m["name"]: m for m in common.benchmark()["per_layer"]}
    for cell, names in PROGRAM_METRICS.items():
        for name in names:
            assert entries[name]["workloads"] == [cell]
            assert entries[name]["source"] in ("program_span", "program_counter")
            assert hasattr(common.load("metrics", name), "read")


@pytest.mark.parametrize("cell", sorted(PROGRAM_METRICS))
def test_a_traced_run_reports_the_program_metrics_and_an_untraced_run_none(cell):
    traced = run(cell, True)
    assert traced["correct"] is True
    for name in PROGRAM_METRICS[cell]:
        assert name in traced["metrics"], name
        assert math.isfinite(traced["metrics"][name]["value"]) and traced["metrics"][name]["value"] >= 0
    untraced = run(cell, False)
    assert untraced["correct"] is True
    assert not set(PROGRAM_METRICS[cell]) & set(untraced["metrics"])


def test_the_prefill_parts_sum_to_the_mean_request_span():
    run("danube_prefill", True)
    parts = program.prefill_parts()
    assert parts["requests"] > 0 and all(parts[k] >= 0 for k in program.PREFILL_PARTS)
    assert math.isclose(sum(parts[k] for k in program.PREFILL_PARTS), parts["total"], rel_tol=1e-9)


def test_the_sar_blocks_copy_their_cropped_azimuth_input():
    """Each block's azimuth FFT takes the leading n_rg columns of planes
    next_pow2(n_rg + chirp_len − 1) wide: made contiguous, 2 × n_az × n_rg
    float32 values; nothing else is copied."""
    line = run("sar_stripmap", True)
    cfg = pb_tiny.SAR["config"]
    assert line["metrics"]["plane_copy_mb.sar"]["value"] == 2 * cfg["n_az"] * cfg["n_rg"] * 4 / 1e6


def test_a_program_without_the_tracing_module_reads_nothing(monkeypatch):
    run("sar_stripmap", True)
    import repro_torch.runtime

    monkeypatch.setitem(sys.modules, "repro_torch.runtime.tracing", None)  # its import fails
    monkeypatch.delattr(repro_torch.runtime, "tracing")
    record = harness.Record(config={}, traffic={}, window_s=1.0, requests=[{"in_slice": True}], attempted=1)
    for names in PROGRAM_METRICS.values():
        for name in names:
            assert common.load("metrics", name).read(record) is None, name
