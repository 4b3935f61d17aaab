"""The dry run's roofline and cell tables, from its artifacts.

Port of ``src/repro/analysis/report.py`` over the port's artifacts
(``artifacts/dryrun_torch``, :mod:`repro_torch.launch.dryrun`): the same
tables and columns, with the trace's seconds where the reference has its
compile seconds.
"""

from __future__ import annotations

import glob
import json
import os

__all__ = ["ART", "ORDER", "SHAPE_ORDER", "load", "status", "roofline_table", "dryrun_table", "summary"]

ART = os.path.join(os.path.dirname(__file__), "..", "..", "..", "artifacts", "dryrun_torch")

ORDER = [
    "gemma3-12b", "h2o-danube-1.8b", "yi-6b", "phi4-mini-3.8b", "arctic-480b",
    "deepseek-moe-16b", "musicgen-large", "xlstm-125m", "zamba2-2.7b",
    "qwen2-vl-72b", "fftbench",
]
SHAPE_ORDER = [
    "train_4k", "prefill_32k", "decode_32k", "long_500k",
    "table1_4096", "table1_16384", "table1_65536", "pod_1m", "pod_16m",
    "sar_4kx8k", "conv_512k",
]


def load(mesh: str, art: str = ART):
    recs = []
    for f in glob.glob(os.path.join(art, f"*__{mesh}.json")):
        with open(f) as fh:
            recs.append(json.load(fh))
    recs.sort(key=lambda r: (ORDER.index(r["arch"]), SHAPE_ORDER.index(r["shape"])))
    return recs


def fmt_ms(s):
    return f"{s*1e3:.1f}"


def status(r) -> str:
    """A record that did not trace: its failure."""
    return f"FAILED: {r.get('error', '')[:40]}"


def roofline_table(mesh: str = "16x16", art: str = ART) -> str:
    rows = [
        "| arch | shape | C (ms) | M (ms) | X (ms) | bound | step LB (ms) | "
        "useful/traced | mem GB | fits |",
        "|---|---|---:|---:|---:|---|---:|---:|---:|---|",
    ]
    for r in load(mesh, art):
        if r["status"] != "ok":
            rows.append(f"| {r['arch']} | {r['shape']} | — | — | — | {status(r)} | | | | |")
            continue
        t = r["roofline"]
        uf = r.get("useful_flops_frac", 0)
        rows.append(
            f"| {r['arch']} | {r['shape']} | {fmt_ms(t['compute_s'])} | "
            f"{fmt_ms(t['memory_s'])} | {fmt_ms(t['collective_s'])} | "
            f"{t['bound']} | {fmt_ms(t['step_lower_bound_s'])} | "
            f"{uf:.0%} | {r['per_chip']['peak_memory_bytes']/1e9:.1f} | "
            f"{'✓' if r['fits_hbm'] else '✗'} |"
        )
    return "\n".join(rows)


def dryrun_table(mesh: str, art: str = ART) -> str:
    rows = [
        "| arch | shape | trace s | per-chip GFLOPs | per-chip GB moved | "
        "coll. GB | coll. ops | status |",
        "|---|---|---:|---:|---:|---:|---:|---|",
    ]
    for r in load(mesh, art):
        if r["status"] != "ok":
            rows.append(f"| {r['arch']} | {r['shape']} | | | | | | {status(r)} |")
            continue
        pc = r["per_chip"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['trace_s']:.0f} | "
            f"{pc['flops']/1e9:.1f} | {pc['hbm_bytes']/1e9:.2f} | "
            f"{pc['collective_bytes']/1e9:.3f} | {int(pc['collective_ops'])} | ok |"
        )
    return "\n".join(rows)


def summary(mesh: str, art: str = ART) -> dict:
    recs = load(mesh, art)
    ok = [r for r in recs if r["status"] == "ok"]
    return {
        "cells": len(recs),
        "traced": len(ok),
        "fits": sum(1 for r in ok if r["fits_hbm"]),
        "bounds": {
            b: sum(1 for r in ok if r["roofline"]["bound"] == b)
            for b in ("compute", "memory", "collective")
        },
    }


if __name__ == "__main__":
    import sys

    mesh = sys.argv[1] if len(sys.argv) > 1 else "16x16"
    print(summary(mesh))
    print(roofline_table(mesh))
