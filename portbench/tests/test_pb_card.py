"""On the card only: each cell run end to end by its command for a short
window (skips here: no CUDA device)."""

import json
import subprocess
import sys

import pb_tiny
import pytest

CELLS = [w["name"] for w in json.loads((pb_tiny.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(card, cell, trace):
    out = subprocess.run([sys.executable, str(pb_tiny.ROOT / "portbench" / "run.py"), "--workload", cell,
                          "--seed", str(2 ** 32 + 17), "--seconds", "5", "--trace", str(trace)],
                         capture_output=True, text=True, timeout=600, cwd=pb_tiny.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
