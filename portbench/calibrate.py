#!/usr/bin/env python3
"""The readings a cell's limit is set from, on the chip, in one process.

    python3 portbench/calibrate.py --workload <cell> --seeds 11,12,... \\
        [--control-seeds 21,22,23] [--faults alter_answer,skip_half] [--seconds 3] [--rates 6,8,10]

* ``program`` lines: a whole run of the cell (set-up, a short window at the
  cell's own load, the check) per seed, with every reading behind the
  compared number;
* ``control`` lines: the reference put in the program's place at the next
  precision down (``control()`` of the cell's driver module), compared by the same rule;
* ``fault`` lines: a run with a fault planted in the timed path, which has
  to come out not correct;
* ``sweep`` lines (``--rates``, an open-loop cell): a whole run at each
  offered rate, for the knee the cell's rate is set below.

One JSON line per reading on standard output.  The benchmark's own runs
never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--rates", default="")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench import common

    common.cache_environment()
    import torch

    from portbench import harness

    device = torch.device("cuda", 0)
    for rate in [float(r) for r in args.rates.split(",") if r]:
        details = {}
        seed = seeds(args.seeds or "1")[0]
        line = harness.run(args.workload, seed, args.seconds, False, t_start=time.perf_counter(), details=details,
                           overrides={"traffic": {"rate_per_s": rate}})
        print(json.dumps({"kind": "sweep", "rate_per_s": rate, "seed": seed, "attempted": line["attempted"],
                          "metrics": line["metrics"], "correct": line["correct"], "checks": line["checks"],
                          "service_ms_mean": details.get("service_ms_mean")}), flush=True)
    if args.rates:
        return 0
    for seed in seeds(args.seeds):
        details = {}
        line = harness.run(args.workload, seed, args.seconds, False, t_start=time.perf_counter(), details=details)
        print(json.dumps({"kind": "program", "seed": seed, "correct": line["correct"], "checks": line["checks"],
                          "details": details, "metrics": line["metrics"]}), flush=True)
    cell = common.cell(args.workload)
    driver = common.load("drivers", cell["workload"]["driver"])
    for seed in seeds(args.control_seeds):
        ctx = harness.Context(cell=cell, seed=seed, seconds=args.seconds, trace=False, device=device)
        print(json.dumps({"kind": "control", "seed": seed, "details": driver.control(ctx)}), flush=True)
        torch.cuda.empty_cache()
    for fault in [f for f in args.faults.split(",") if f]:
        seed = seeds(args.seeds or "1")[0]
        line = harness.run(args.workload, seed, args.seconds, False, t_start=time.perf_counter(), faults=(fault,))
        print(json.dumps({"kind": "fault", "fault": fault, "seed": seed, "correct": line["correct"],
                          "checks": line["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
