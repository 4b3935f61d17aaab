"""Compare the chip_smoke.py runs of scripts/chip_ab.sh: parent against
change, every kernel row and every planned call both sides printed.

    python3 scripts/ab_table.py <out dir of scripts/chip_ab.sh>

For each (kernel, shape) of phase 2 and each call of phases 3, 5 and 6
prints the parent's and the change's times (the mean of their two runs
each), change / parent, and the change's bound where the row has one; a
row only the change prints has no parent time.
"""

from __future__ import annotations

import json
import statistics
import sys
from collections import defaultdict
from pathlib import Path


def rows(path: Path) -> dict:
    """{(tag, key): ms} of one chip_smoke.py log."""
    out = {}
    for line in path.read_text().splitlines():
        tag, _, body = line.partition(" ")
        if tag == "kernel":
            r = json.loads(body)
            out[(r["name"], r["shape"])] = (r["ms"], r["bound_ms"], r["registers"])
        elif tag == "main_path":
            r = json.loads(body)
            out[("fft", f"n={r['n']} B={r['batch']}")] = (r["fft_ms"], None, None)
            out[("ifft", f"n={r['n']} B={r['batch']}")] = (r["ifft_ms"], None, None)
        elif tag in ("real2d", "any_length"):
            r = json.loads(body)
            out[(r["call"], "forward")] = (r["ms"], None, None)
            out[(r["call"], r["inverse"])] = (r["inverse_ms"], None, None)
    return out


def main() -> int:
    d = Path(sys.argv[1])
    runs = defaultdict(list)
    for log in sorted(d.glob("ab[0-9]_*.log")):
        runs[log.stem.split("_", 1)[1]].append(rows(log))
    parent, change = runs["parent"], runs["change"]
    keys = [k for k in change[0] if all(k in r for r in change)]
    print("| row | shape | parent ms | change ms | change / parent | bound ms |")
    print("|---|---|---|---|---|---|")
    for k in keys:
        c = statistics.mean(r[k][0] for r in change)
        bound = change[0][k][1]
        b = f"{bound:.4f}" if bound is not None else ""
        if all(k in r for r in parent):
            p = statistics.mean(r[k][0] for r in parent)
            print(f"| {k[0]} | {k[1]} | {p:.4f} | {c:.4f} | {c / p:.3f} | {b} |")
        else:
            print(f"| {k[0]} | {k[1]} | | {c:.4f} | | {b} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
