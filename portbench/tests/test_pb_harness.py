"""Whole runs of each cell at a tiny size on the CPU route: the result
line, ``correct`` for a sound run and not for a run whose timed path is
broken underneath, a traced run, and a cell added as data alone."""

import json
import shutil
import subprocess
import sys
import time

import pb_tiny
import pytest

from portbench import common, harness

CELLS = sorted(pb_tiny.TINY)
LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def run(cell, seed=2 ** 33 + 7, seconds=0.6, trace=False, faults=()):
    return harness.run(cell, seed, seconds, trace, t_start=time.perf_counter(), device="cpu",
                       faults=faults, overrides=pb_tiny.TINY[cell])


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct_and_its_line_has_the_five_keys(cell):
    line = run(cell)
    assert list(line)[:5] == LINE_KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert {"setup_s"} < set(line["metrics"])
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]
    json.dumps(line)


FAULTS = [(cell, fault) for cell in CELLS for fault in common.workload(cell)["check"]["faults"]]


@pytest.mark.parametrize("cell, fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(cell, fault):
    """Each fault the cell can have (its workload file lists them): an
    answer altered where it is made; half of a batch of scenes left out."""
    line = run(cell, faults=(fault,))
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reports_per_layer_metrics_and_the_slice(cell):
    line = run(cell, seconds=1.5, trace=True)
    assert line["correct"] is True
    assert "setup_s" not in line["metrics"] and line["metrics"]
    assert line["device"]["window_s"] > 0 and line["device"]["busy_s"] >= 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in line["breakdown"].values())


def test_same_seed_same_inputs():
    cell = common.cell("sar_stripmap")
    pipeline = common.load("pipelines", "stripmap")
    cfg = {**cell["config"], **pb_tiny.SAR["config"]}
    a = pipeline.Pipeline(cfg, cell["workload"]["traffic"], harness.torch.device("cpu"), 2 ** 40 + 3)
    b = pipeline.Pipeline(cfg, cell["workload"]["traffic"], harness.torch.device("cpu"), 2 ** 40 + 3)
    assert harness.torch.equal(a.raw_i, b.raw_i) and harness.torch.equal(a.raw_q, b.raw_q)


def test_a_cell_added_as_data_alone_runs(tmp_path):
    """A spotlight cell like the Open questions' first: a configuration file,
    a workload file and their entries, nothing else edited."""
    root = tmp_path / "checkout"
    shutil.copytree(pb_tiny.ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((pb_tiny.ROOT / "BENCHMARK.json").read_text())
    before = {p.relative_to(root): p.read_bytes() for p in (root / "portbench").rglob("*") if p.is_file()}
    bench["configs"].append({"name": "spotlight_test", "source": "a test configuration",
                             "file": "portbench/configs/spotlight_test.json", "reduced": [], "why": "a test"})
    (root / "portbench" / "configs" / "spotlight_test.json").write_text(json.dumps(
        {"name": "spotlight_test", "source": "a test configuration", "reduced": [], **pb_tiny.SPOTLIGHT}))
    bench["workloads"].append({"name": "sar_spotlight", "config": "spotlight_test", "traffic": "spotlight_closed32",
                               "chips": 1, "why": "spotlight scenes, one planned fft2 and the magnitude each"})
    for m in bench["end_to_end"]:
        if m["name"] in ("samples_per_s", "call_ms_p95"):
            m["workloads"].append("sar_spotlight")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "portbench" / "workloads" / "sar_spotlight.json").write_text(json.dumps({
        "name": "sar_spotlight", "config": "spotlight_test", "driver": "fft_stream", "pipeline": "spotlight", "chips": 1,
        "why": "spotlight", "traffic": {"name": "spotlight_closed32", "ahead": 32, "check_sample": 32,
                                         "trace_slice": [0.4, 2.0]},
        "check": {"limits": {"image_err": 1e-4}}}))
    after = {p.relative_to(root): p.read_bytes() for p in (root / "portbench").rglob("*") if p.is_file()}
    assert all(after[k] == v for k, v in before.items())  # no existing file edited
    prog = (f"import sys, json, time; sys.path[:0] = [{str(root)!r}, {str(pb_tiny.ROOT / 'src')!r}]\n"
            "from portbench import harness\n"
            "line = harness.run('sar_spotlight', 5, 0.5, False, t_start=time.perf_counter(), device='cpu',\n"
            "    overrides={'traffic': {'ahead': 2}})\n"
            "print(json.dumps(line))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True, timeout=300, check=True)
    line = json.loads(out.stdout.splitlines()[-1])
    assert line["correct"] is True and set(line["metrics"]) == {"samples_per_s", "call_ms_p95", "setup_s"}


def test_run_refuses_without_a_card():
    out = subprocess.run([sys.executable, str(pb_tiny.ROOT / "portbench" / "run.py"), "--workload", "sar_stripmap",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_run_refuses_in_a_checkout_of_the_benchmark_alone(tmp_path):
    shutil.copytree(pb_tiny.ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(pb_tiny.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, str(tmp_path / "portbench" / "run.py"), "--workload", "sar_stripmap",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout == ""
