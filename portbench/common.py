"""Paths and the loaders that find a cell's files by the names in ``BENCHMARK.json``.

Everything that belongs to one configuration, traffic mix, driver, pipeline
or metric sits in a file of its own under ``portbench/``:

    configs/<config>.json      workloads/<cell>.json
    drivers/<driver>.py        pipelines/<pipeline>.py
    metrics/<metric>.py        (one reader per metric, end-to-end or per layer)

A new cell, configuration or metric is added as new files and entries; no
existing file is edited.  A metric's file is named by the metric itself
(``metrics/enqueue_ms.sar.py``), so the modules are loaded by path.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from pathlib import Path

#: The root of the checkout (the directory holding ``BENCHMARK.json``).
ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "portbench"
#: Where the benchmark and the program keep their caches: inside the
#: checkout, at fixed paths, in a directory ``.gitignore`` lists.
CACHE = ROOT / "build"

KINDS = ("drivers", "pipelines", "metrics")


def cache_environment() -> None:
    """Every build and cache directory of the program at a fixed path inside
    the checkout; set before the port is imported."""
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(CACHE / "repro_torch_kernels")
    os.environ["REPRO_TUNING_CACHE"] = str(CACHE / "portbench" / "tuning.json")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return read_json(ROOT / "BENCHMARK.json")


def workload(name: str) -> dict:
    return read_json(BENCH / "workloads" / f"{name}.json")


def config(name: str) -> dict:
    return read_json(BENCH / "configs" / f"{name}.json")


def module_path(kind: str, name: str) -> Path:
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}; one of {KINDS}")
    return BENCH / kind / f"{name}.py"


def load(kind: str, name: str):
    """The module ``portbench/<kind>/<name>.py``, loaded once per process."""
    key = f"portbench_{kind}_" + "".join(c if c.isalnum() else "_" for c in name)
    if key in sys.modules:
        return sys.modules[key]
    path = module_path(kind, name)
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} file {path.relative_to(ROOT)} for {name!r}")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[key]
        raise
    return mod


def cell(name: str) -> dict:
    """One cell, resolved: its ``BENCHMARK.json`` entry, its workload file,
    its configuration's file, and the metrics it reports (``end_to_end``
    and ``per_layer`` entries)."""
    bench = benchmark()
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; one of {sorted(entries)}")
    entry = entries[name]
    wl = workload(name)
    if wl["config"] != entry["config"] or wl["traffic"]["name"] != entry["traffic"]:
        raise ValueError(f"portbench/workloads/{name}.json names config {wl['config']!r} and traffic "
                         f"{wl['traffic']['name']!r}; BENCHMARK.json {entry['config']!r} and {entry['traffic']!r}")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    cfg = read_json(ROOT / cfg_entry["file"])
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    # A per-layer metric without a ``workloads`` key is reported by every
    # cell that reports the end-to-end metric it moves.
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    return {"name": name, "entry": entry, "workload": wl, "config": cfg, "end_to_end": e2e, "per_layer": per_layer}
