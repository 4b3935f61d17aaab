"""Time the whole-signal kernels (``dft_matmul``, ``fft4step``) of one tree
of this repository on the card, back to back.

    python3 scripts/kernel_ab.py <tree> [label]

``<tree>`` is an unpacked checkout (``git archive``) of this repository, of
this commit or an earlier one: the script imports that tree's
``repro_torch``, builds its kernels into the tree's own ``build/``, and
calls each kernel's wrapper with that tree's LUTs (the DFT matrices of the
GEMM kernels before the radix redesign, the roots table after it) at the
shapes ``chip_smoke.py``'s phase 2 gives them.  A kernel's time is the
median over 5 batches of the mean of 20 back-to-back calls between two
CUDA events, so the wrappers' host time hides behind the queued launches
(``chip_smoke.py`` times one call per event pair, which adds it).  Each
output is checked against ``torch.fft`` first.  Prints one JSON line per
(kernel, shape) and the card's name and power limit.

Run parent and change in turns in one call (parent, change, change,
parent) to compare them on one card.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

import torch

#: (kernel, batch, n, orders): phase 2's shapes of the two kernels.
SHAPES = (
    ("dft_matmul", 16384, 1024, ("natural",)),
    ("fft4step", 4096, 4096, ("natural", "k1-major")),
    ("fft4step", 4096, 16384, ("natural", "k1-major")),
    ("fft4step", 1024, 65536, ("natural", "k1-major")),
)


def time_ms(fn, reps: int = 20, batches: int = 5) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    means = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        means.append(start.elapsed_time(end) / reps)
    return statistics.median(means)


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA device", file=sys.stderr)
        return 2
    tree = os.path.abspath(sys.argv[1])
    label = sys.argv[2] if len(sys.argv) > 2 else os.path.basename(tree)
    sys.path.insert(0, os.path.join(tree, "src"))
    from repro_torch.core import plan as plan_lib
    from repro_torch.kernels import build, dft_matmul, fft4step, ops

    build.build()
    dev = ops.device_key("cuda")
    radix = hasattr(ops, "_roots_luts")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for kernel, b, n, orders in SHAPES:
        xr = torch.randn(b, n, device="cuda", generator=gen)
        xi = torch.randn(b, n, device="cuda", generator=gen)
        ref = torch.fft.fft(torch.complex(xr, xi))
        n1, n2 = plan_lib.balanced_split(n)
        for order in orders:
            natural = order == "natural"
            if kernel == "dft_matmul":
                luts = ops._roots_luts(dev, n, False) if radix else ops._direct_luts(dev, n, False)
                call = lambda: dft_matmul.dft_matmul_call(xr, xi, *luts)  # noqa: E731
            elif radix:
                luts = ops._roots_luts(dev, n, False)
                call = lambda: fft4step.fft4step_call(  # noqa: E731
                    xr, xi, *luts, n1=n1, natural_order=natural)
            else:
                luts = ops._fused_luts(dev, n1, n2, False)
                call = lambda: fft4step.fft4step_call(  # noqa: E731
                    xr, xi, *luts, natural_order=natural)
            yr, yi = call()
            want = ref if natural else ref.view(b, n2, n1).transpose(1, 2).reshape(b, n)
            err = ((torch.complex(yr, yi) - want).abs().max() / want.abs().max()).item()
            if not err <= 1e-3:
                print(f"kernel_ab: {kernel} n={n} {order} off by {err:.3e}", file=sys.stderr)
                return 1
            del yr, yi
            print(json.dumps({
                "tree": label, "kernel": kernel, "batch": b, "n": n, "order": order,
                "ms": time_ms(call), "bytes": 16 * b * n, "rel_err": err,
            }), flush=True)
        del xr, xi, ref
        torch.cuda.empty_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
