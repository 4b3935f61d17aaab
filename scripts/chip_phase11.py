"""Run ``chip_smoke.py``'s phase 11 alone on the card: build the kernels,
serve deepseek-moe-16b with spectral mixing at full width (the
``serve_moe`` line), then hold each distinct kernel call it made against
its plain version ("kernel ... moe path #i" lines).

    python3 scripts/chip_phase11.py

A quicker loop than the whole smoke run while the MoE path changes; the
smoke run stays the proof.  Exits 1 on the first failed check.
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_phase11: no CUDA device", file=sys.stderr)
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
    t0 = time.perf_counter()
    try:
        with cs.tune_env("off"), cs.recorded_calls() as seen, torch.no_grad():
            moe = cs.path_launches("moe", cs.moe_phase, gen)
        print(f"phase 11: {time.perf_counter() - t0:.1f} s, {len(seen)} distinct kernel calls", flush=True)
        cs.path_kernel_rows("moe", seen, moe, gen)
    except cs.SmokeFailure as err:
        print(f"chip_phase11: FAILED: {err}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
