"""The import guard: nothing the benchmark loads is JAX or the JAX package,
and the references load nothing of the program either."""

import ast
import json
import subprocess
import sys

import pb_tiny
import pytest

from portbench import guard

ROOT = pb_tiny.ROOT


def test_top_level_names_are_compared_whole():
    assert guard.forbidden(["repro_torch", "repro_torch.core.fft", "reprox", "jax_like"]) == []
    assert guard.forbidden(["repro.core.fft", "jax.numpy", "jaxlib", "flax.linen"]) == ["flax", "jax", "jaxlib", "repro"]


def loaded_by(code: str) -> set:
    """The top-level module names a fresh interpreter has loaded after ``code``."""
    prog = (f"import sys; sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n{code}\n"
            "import json; print(json.dumps(sorted({m.partition('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_everything_a_run_loads_is_free_of_jax():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    code = ["from portbench import common, harness, guard, trace, spans, need, stats, traffic, compare",
            "import portbench.reference.sar, portbench.reference.danube",
            "import repro_torch.kernels, repro_torch.core.conv, repro_torch.serving.engine, repro_torch.models.model"]
    for w in bench["workloads"]:
        cell = f"common.cell({w['name']!r})"
        code.append(f"c = {cell}; common.load('drivers', c['workload']['driver'])")
        code.append("'pipeline' in c['workload'] and common.load('pipelines', c['workload']['pipeline'])")
        code.append("[common.load('metrics', m['name']) for m in c['end_to_end'] + c['per_layer'] if m['name'] != 'setup_s']")
    for f in (ROOT / "portbench" / "pipelines").glob("*.py"):
        code.append(f"common.load('pipelines', {f.stem!r})")
    names = loaded_by("\n".join(code))
    assert "repro_torch" in names
    assert guard.forbidden(names) == []


@pytest.mark.parametrize("module", ["sar", "danube"])
def test_references_import_nothing_of_the_program(module):
    names = loaded_by(f"import portbench.reference.{module}")
    assert "repro_torch" not in names and guard.forbidden(names) == []
    tree = ast.parse((ROOT / "portbench" / "reference" / f"{module}.py").read_text())
    imported = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported |= {a.name.partition(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            imported.add((node.module or "").partition(".")[0])
    assert imported <= {"__future__", "contextlib", "math", "typing", "torch"}


def test_guard_check_raises_on_a_forbidden_module(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", object())
    with pytest.raises(ImportError):
        guard.check("test")
