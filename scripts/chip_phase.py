"""Run one of ``chip_smoke.py``'s serving phases alone on the card: build the
kernels, then phase 11 (deepseek-moe-16b with spectral mixing at full width,
the ``serve_moe`` line, then each distinct kernel call it made against its
plain version, "kernel ... moe path #i" lines), phase 12 (zamba2-2.7b and
xlstm-125m at full width, the ``serve_recurrent`` lines; no kernel
launches) or phase 13 (musicgen-large with spectral mixing and plain,
qwen2-vl-72b at 8 of 80 layers, the ``serve_frontend`` lines, then
"kernel ... frontend path #i" lines) or phase 14 (the distributed pencil
FFT: one rank over NCCL at fftbench's sizes, then four spawned ranks on the
card over gloo, the ``pencil`` lines, then "kernel_check ... distributed"
lines) or phase 15 (sharded training: one rank over NCCL, then four
spawned ranks on the card over gloo, the ``sharded`` lines, then
"kernel_check ... sharded" lines; run alone, it first takes phase 10 (c)'s
unsharded steps for (a)'s baseline) or phase 16 (the dry run held against
the card: traces of phase 10 (c)'s step, phase 8's prefill, decode step and
flush step and phase 14 (a)'s transforms against the real runs, sharded serving at
world 1 and on four gloo ranks, the production cells through
``run_cell``; the ``dryrun`` and ``dryrun_cell`` lines, then
"kernel_check ... dryrun" lines) or phase 17 (the reference's decode
sharding on four spawned gloo ranks: gemma3-12b weight-stationary over
524288-position caches, the sequence-sharded attention, h2o + spectral at
a batch of 1; the ``long`` lines, then "kernel_check ... long" lines) or
phase 18 (the executor's reorder program at 2^29, pencil order at 2^26,
the tuner's three-factor candidates at 2^29, the four examples on the card
with the SAR scenes at 4096 x 8192, and the reorder program at 2^30 where
the budget leaves room; the ``executor``, ``sar`` and ``examples`` lines,
then "kernel_check ... examples" lines).

    python3 scripts/chip_phase.py 11
    python3 scripts/chip_phase.py 12
    python3 scripts/chip_phase.py 13
    python3 scripts/chip_phase.py 14
    python3 scripts/chip_phase.py 15
    python3 scripts/chip_phase.py 16
    python3 scripts/chip_phase.py 17
    python3 scripts/chip_phase.py 18

A quicker loop than the whole smoke run while a serving path changes; the
smoke run stays the proof.  Exits 1 on the first failed check.
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

#: Phase → (its path's name in ``chip_smoke.PATH_KERNELS``, the phase).
PHASES = {11: ("moe", cs.moe_phase), 12: ("hybrid", cs.recurrent_phase), 13: ("frontend", cs.frontend_phase),
          14: ("distributed", None), 15: ("sharded", None), 16: ("dryrun", None), 17: ("long", None),
          18: ("examples", None)}


def main(argv) -> int:
    if len(argv) != 1 or int(argv[0]) not in PHASES:
        print(f"usage: chip_phase.py {{{','.join(map(str, PHASES))}}}", file=sys.stderr)
        return 2
    phase = int(argv[0])
    if not torch.cuda.is_available():
        print("chip_phase: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    cs.build.build()
    cs.build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    cs.ATTRS.update(cs.build.kernel_attributes())
    cache_dir = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(cache_dir, exist_ok=True)
    os.environ["REPRO_TUNING_CACHE"] = os.path.join(cache_dir, "tuning.json")
    gen = torch.Generator(device="cuda").manual_seed(0)
    path, run = PHASES[phase]
    t0 = time.perf_counter()
    try:
        if run is None:  # phases 14–18 drive their own paths, ranks and all
            {14: cs.distributed_path, 15: cs.sharded_path, 16: cs.dryrun_path, 17: cs.long_path,
             18: cs.examples_path}[phase](gen)
            print(f"phase {phase} alone: {time.perf_counter() - t0:.1f} s", flush=True)
            return 0
        with cs.tune_env("off"), cs.recorded_calls() as seen, torch.no_grad():
            launches = cs.path_launches(path, run, gen)
        print(f"phase {phase}: {time.perf_counter() - t0:.1f} s, {len(seen)} distinct kernel calls", flush=True)
        cs.path_kernel_rows(path, seen, launches, gen)
    except cs.SmokeFailure as err:
        print(f"chip_phase: FAILED: {err}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
