"""Rank the kernels and the host glue by their gap on the card, from the
change runs of ``scripts/chip_ab.sh``.

    python3 scripts/gaps.py <out dir of scripts/chip_ab.sh>

A kernel's gap is launches × (ms − bound ms), summed over the calls of
``chip_smoke.py``'s phases 3, 5 and 6 (``ROADMAP.md`` B's ordering rule).
Each call runs 5 times forward and 5 times inverse (checked, warm-up and 3
timed), and each of its passes takes the time and bound of the phase-2 row
of its shape, scaled by batch where the call's batch differs from the
row's.  The host glue of a call is its time minus its passes' kernel times,
5 times per direction.  Times are the mean of the change runs.  The launch
counts this mapping implies are checked against the ``*_launches`` lines
the runs printed.  Prints the gap of each kernel, of each kernel within
each call, and the host glue of each call.
"""

from __future__ import annotations

import json
import statistics
import sys
from collections import defaultdict
from pathlib import Path

#: Runs of each call per direction, as chip_smoke.py's calls_phase and
#: main_path_phase make them.
RUNS = 5


def _pair(kernel_fwd, kernel_inv, row):
    return [(kernel_fwd, row, 1), (kernel_inv, row, 1)]


#: The forward passes of every call: (kernel, phase-2 row shape prefix,
#: batch scale).  The inverse call runs the same rows, ``irfft_recomb`` for
#: ``rfft_recomb`` and a row's " inverse" twin where phase 2 has one.
CALLS = {
    "fft n=1024": [("dft_matmul", "B=16384 N=1024", 1)],
    "fft n=4096": [("fft4step", "B=4096 n=4096 (64x64) natural", 1)],
    "fft n=16384": [("fft4step", "B=4096 n=16384 (128x128) natural", 1)],
    "fft n=65536": [("fft4step", "B=1024 n=65536 (256x256) natural", 1)],
    **{f"fft n={n}": [("cols_pass", f"n={n} B={b} (R=", 1), ("rows_natural", f"n={n} B={b} (B=", 1)]
       for n, b in ((1 << 20, 64), (1 << 22, 16), (1 << 24, 4), (1 << 26, 2))},
    "rfft 8192x16384": [("fft4step", "B=8192 n=8192", 1), ("rfft_recomb", "B=16384 m=8192", 0.5)],
    "rfft 64x2097152": [("cols_pass", "n=1048576 B=64 (R=", 1),
                        ("rows_natural", "n=1048576 B=64 (B=", 1),
                        ("rfft_recomb", "B=16384 m=8192", 0.5)],
    "fft2 1x16384x16384": [("fft4step", "B=4096 n=16384 (128x128) natural", 4),
                           ("cols_pass", "rfft2 columns (R=1, f=16384, s=8192)", 2)],
    "fft2 1x131072x2048": [("fft4step", "B=131072 n=2048", 1),
                           ("cols_pass", "fft2 131072x2048 strided", 1),
                           ("cols_natural", "fft2 131072x2048 last", 1)],
    "rfft2 1x16384x16384": [("fft4step", "B=8192 n=8192", 2), ("rfft_recomb", "B=16384 m=8192", 1),
                            ("cols_pass", "rfft2 columns (R=1, f=16384, s=8193)", 1)],
    "fft 16384x4096 axis=-2": [("cols_pass", "fft axis=-2 columns", 1)],
    "fft 16384x500": _pair("bluestein_fwd", "bluestein_inv", "B=16384 n=500"),
    "fft 8192x3000": _pair("bluestein_fwd", "bluestein_inv", "B=8192 n=3000"),
    "fft 2048x12288": _pair("bluestein_fwd", "bluestein_inv", "B=2048 n=12288"),
    "fft 64x100003": [("bluestein_elem", "pre B=64", 1), ("bluestein_elem", "mul B=64", 1),
                      ("bluestein_elem", "post B=64", 1)]
    + 2 * [("cols_pass", "n=262144 B=64 (R=", 1), ("rows_natural", "n=262144 B=64 (B=", 1)],
    "rfft 8192x4999": _pair("bluestein_fwd", "bluestein_inv", "B=8192 n=4999"),
    "rfft 8192x6000": _pair("bluestein_fwd", "bluestein_inv", "B=8192 n=3000")
    + [("rfft_recomb", "B=8192 m=3000", 1)],
    "fft2 1x4096x3000": _pair("bluestein_fwd", "bluestein_inv", "B=4096 n=3000")
    + [("cols_pass", "fft2 columns (R=1, f=4096, s=3000)", 1)],
    "fft2 1x131072x500": _pair("bluestein_fwd", "bluestein_inv", "B=131072 n=500")
    + [("cols_pass", "fft2 131072x500 strided", 1), ("cols_natural", "fft2 131072x500 last", 1)],
    "fft 3000x4096 axis=-2": _pair("bluestein_fwd", "bluestein_inv", "B=4096 n=3000"),
}


def read(log: Path) -> tuple:
    """({(kernel, shape): (ms, bound)}, {call: (fwd ms, inv ms)},
    {kernel: launches}) of one chip_smoke.py log."""
    rows, calls, launches = {}, {}, defaultdict(int)
    for line in log.read_text().splitlines():
        tag, _, body = line.partition(" ")
        if tag == "kernel":
            r = json.loads(body)
            rows[(r["name"], r["shape"])] = (r["ms"], r["bound_ms"])
        elif tag == "main_path":
            r = json.loads(body)
            calls[f"fft n={r['n']}"] = (r["fft_ms"], r["ifft_ms"])
        elif tag in ("real2d", "any_length"):
            r = json.loads(body)
            calls[r["call"]] = (r["ms"], r["inverse_ms"])
        elif tag.endswith("_launches"):
            for k, v in json.loads(body).items():
                launches[k] += v
    return rows, calls, launches


def find(rows: dict, kernel: str, prefix: str, inverse: bool) -> tuple:
    """(ms, bound) of the first row of ``kernel`` whose shape starts with
    ``prefix``; for an inverse pass its " inverse" twin where there is one."""
    tries = [prefix.replace(" natural", "") + " inverse", prefix] if inverse else [prefix]
    for p in tries:
        keys = [s for k, s in rows if k == kernel and s.startswith(p)
                and (inverse or not s.endswith(" inverse"))]
        if keys:
            return rows[(kernel, keys[0])]
    raise KeyError(f"no {kernel} row starts with {prefix!r}")


def main() -> int:
    logs = sorted(Path(sys.argv[1]).glob("ab[0-9]_change.log"))
    runs = [read(log) for log in logs]
    rows = {k: tuple(statistics.mean(r[0][k][i] for r in runs) for i in (0, 1)) for k in runs[0][0]}
    calls = {k: tuple(statistics.mean(r[1][k][i] for r in runs) for i in (0, 1)) for k in runs[0][1]}
    gap, launches, glue, by_row = defaultdict(float), defaultdict(int), {}, defaultdict(float)
    for call, passes in CALLS.items():
        glue[call] = 0.0
        for d, inverse in enumerate((False, True)):
            kernel_ms = 0.0
            for kernel, prefix, scale in passes:
                if inverse:
                    kernel = {"rfft_recomb": "irfft_recomb"}.get(kernel, kernel)
                ms, bound = find(rows, kernel, prefix, inverse)
                gap[kernel] += RUNS * scale * (ms - bound)
                by_row[(kernel, call)] += RUNS * scale * (ms - bound)
                launches[kernel] += RUNS
                kernel_ms += scale * ms
            glue[call] += RUNS * (calls[call][d] - kernel_ms)
    logged = runs[0][2]
    for kernel, n in launches.items():
        if logged.get(kernel) != n:
            print(f"gaps: {kernel} launched {logged.get(kernel)} times, the mapping counts {n}",
                  file=sys.stderr)
            return 1
    out = sorted(gap.items(), key=lambda kv: -kv[1]) + [("host glue", sum(glue.values()))]
    print("| kernel | launches | gap ms |")
    print("|---|---|---|")
    for name, g in sorted(out, key=lambda kv: -kv[1]):
        print(f"| {name} | {launches.get(name, '')} | {g:.1f} |")
    print()
    print("| kernel | in call | gap ms |")
    print("|---|---|---|")
    for (kernel, call), g in sorted(by_row.items(), key=lambda kv: -kv[1]):
        print(f"| {kernel} | {call} | {g:.1f} |")
    print()
    print("| call | host glue ms |")
    print("|---|---|")
    for call, g in sorted(glue.items(), key=lambda kv: -kv[1]):
        print(f"| {call} | {g:.1f} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
