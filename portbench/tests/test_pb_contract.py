"""``BENCHMARK.json`` against the benchmark's contract: its keys, names,
units and limits, and every cell resolving to its files under ``portbench/``."""

import json
import re

import pb_tiny
import pytest

from portbench import common

ROOT = pb_tiny.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "proj", "head", "expansion", "expert", "width")


def line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def cells_reporting(metric):
    return [w["name"] for w in BENCH["workloads"] if w["name"] in metric.get("workloads", [w["name"]])]


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_command_and_paths():
    cmd, paths = BENCH["command"], BENCH["paths"]
    assert 1 <= len(cmd) <= 32 and all(line(w) for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
    for word in cmd:
        if "/" in word:
            assert not word.startswith("/") and ".." not in word.split("/")
            assert any(word == p or word.startswith(p + "/") for p in paths), word
            assert (ROOT / word).exists()


def test_run_seconds_fits_the_full_check_of_24_cells():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_are_unique_and_well_formed():
    for group in ("configs", "workloads"):
        names = [x["name"] for x in BENCH[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics)) and all(NAME.match(n) for n in metrics)


def test_configs():
    assert 1 <= len(BENCH["configs"]) <= 24
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert line(c["source"]) and line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and key in cfg
            assert not key.endswith(("_dim", "_rank")) and not any(w in key for w in WIDTH_WORDS), key
        assert c["name"] in used


def test_workloads():
    ws = BENCH["workloads"]
    assert 1 <= len(ws) <= 24
    assert len({(w["config"], w["traffic"]) for w in ws}) == len(ws)
    four = [w for w in ws if w["chips"] == 4]
    assert len(four) <= max(1, len(ws) // 4)
    configs = {c["name"] for c in BENCH["configs"]}
    for w in ws:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and w["config"] in configs
        assert NAME.match(w["traffic"]) and line(w["why"])


def test_end_to_end_metrics():
    e2e = BENCH["end_to_end"]
    assert 1 <= len(e2e) <= 16
    names = {w["name"] for w in BENCH["workloads"]}
    for m in e2e:
        assert E2E_KEYS <= set(m) <= E2E_KEYS | {"workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", [])) <= names
    setup = next(m for m in e2e if m["name"] == "setup_s")
    assert "workloads" not in setup and setup["bound"] <= 0.25


def test_per_layer_metrics():
    pl = BENCH["per_layer"]
    assert 1 <= len(pl) <= 128
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    layers = {}
    for m in pl:
        assert LAYER_KEYS <= set(m) <= LAYER_KEYS | {"workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert line(m["layer"]) and m["moves"] in e2e
        for cell in m.get("workloads", []):
            assert cell in cells_reporting(e2e[m["moves"]]), (m["name"], cell)
        if m["name"].endswith("_roofline") or "mfu" in m["name"].split("."):
            assert m["unit"] == "%"
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())  # one spelling a layer


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    resolved = common.cell(cell)
    names = [m["name"] for m in resolved["end_to_end"]]
    assert "setup_s" in names and len(names) >= 2
    assert resolved["per_layer"]


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_workload_file_resolves_to_its_files(cell):
    resolved = common.cell(cell)
    wl = resolved["workload"]
    assert wl["name"] == cell and wl["chips"] == resolved["entry"]["chips"]
    assert common.module_path("drivers", wl["driver"]).is_file()
    if "pipeline" in wl:
        assert common.module_path("pipelines", wl["pipeline"]).is_file()
    for m in resolved["end_to_end"] + resolved["per_layer"]:
        if m["name"] != "setup_s":
            assert hasattr(common.load("metrics", m["name"]), "read"), m["name"]
    limits = wl["check"]["limits"]
    assert limits and all(NAME.match(n) and limit >= 0 for n, limit in limits.items())


def test_files_under_paths_are_named_from_name_characters():
    for p in BENCH["paths"]:
        for f in (ROOT / p).rglob("*"):
            if f.is_file() and "__pycache__" not in f.parts:
                assert PATH.match(str(f.relative_to(ROOT))), f
