"""Quickest proof that the PyTorch/CUDA port runs on the card.

    python3 chip_smoke.py

Drives the port only (``src/repro_torch``; nothing of JAX or of the JAX
package), in phases, and fails on the first check that does not hold:

1. device — the card's name and power limit, and the build of every kernel
   from ``src/repro_torch/csrc`` (its wall time);
2. kernels — each of the four CUDA kernels at main-path shapes against its
   plain PyTorch version on the same inputs (max|Δ| ≤ 1e-4·max|plain|),
   with its time, the plain version's, its bound (the larger of bytes over
   HBM bandwidth and flops over the FP32 peak) and, where one library call
   computes the same function, that call's time;
3. main path — ``plan(FFTSpec(n))`` forward and ``ifft`` at full-size
   remote-sensing shapes: sample rows against ``np.fft`` in complex128 at
   1e-3·max|ref|, ``ifft(fft(x)) ≈ x``, exactly ``len(plan.passes)`` kernel
   launches and no plain call in every planned call (checked and timed), the
   time per call beside one ``torch.fft.fft`` call (the library yardstick),
   and the device memory one forward call holds beyond its input;
4. offsets — two planned calls with just over 2^31 elements per plane,
   sample rows against ``np.fft``: the kernels' 64-bit addressing, and the
   device memory each call holds (planes in and out, scratch slab).

It then prints the per-kernel JSON line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits non-zero
and prints no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import kernels  # noqa: E402
from repro_torch.core import fft as F  # noqa: E402
from repro_torch.core import plan as plan_lib  # noqa: E402
from repro_torch.kernels import build, dft_matmul, fft4step, ops, pencil  # noqa: E402

#: Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W): FP32 on
#: the CUDA cores and HBM3 bandwidth.
FP32_PEAK = 67e12
HBM_BYTES_PER_S = 3.35e12

KERNEL_TOL = 1e-4  # kernel vs its plain version, relative to max|plain|
FFT_TOL = 1e-3  # planned call vs np.fft in complex128, relative to max|ref|

#: (n, batch): complex64 signals of 0.13–1 GB each.  n = 16384 is one
#: 4096-line SAR range block; 2^20 … 2^26 are the two-pass programs.
MAIN_PATH = (
    (1024, 16384),
    (4096, 4096),
    (16384, 4096),
    (65536, 1024),
    (1 << 20, 64),
    (1 << 22, 16),
    (1 << 24, 4),
    (1 << 26, 2),
)

SOURCES = {
    "dft_matmul": ("src/repro_torch/csrc/dft_matmul.cu", "src/repro/kernels/dft_matmul.py:67"),
    "fft4step": ("src/repro_torch/csrc/fft4step.cu", "src/repro/kernels/fft4step.py:114"),
    "cols_pass": ("src/repro_torch/csrc/pencil.cu", "src/repro/kernels/pencil.py:102"),
    "rows_natural": ("src/repro_torch/csrc/pencil.cu", "src/repro/kernels/pencil.py:178"),
}


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def time_ms(fn, reps: int = 5, warmup: int = 1) -> float:
    """Median over ``reps`` CUDA-event-timed calls, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_PEAK * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(got, want) -> tuple:
    err = max((got[0] - want[0]).abs().max().item(), (got[1] - want[1]).abs().max().item())
    scale = max(want[0].abs().max().item(), want[1].abs().max().item())
    return err, scale


def planes(gen, *shape):
    return (
        torch.randn(*shape, device="cuda", generator=gen),
        torch.randn(*shape, device="cuda", generator=gen),
    )


def transform_flops(kind: str, f: int, n1: int, n2: int) -> int:
    """fp32 flops that one length-f transform needs: 6 per complex
    multiply-add of the DFT products (three real GEMMs, the Karatsuba form of
    the reference and of the plain versions) plus 4 per point of their pre-
    and post-adds, and 6 per complex twiddle multiply.  The CUDA tiles spend
    8 per multiply-add (4 FMAs); that is their design, not the work."""
    if kind == "direct":
        return 6 * f * f + 4 * f
    return 6 * f * (n1 + n2) + 4 * f + 6 * f + 4 * f


def lut_bytes(kind: str, f: int, n1: int, n2: int) -> int:
    if kind == "direct":
        return 8 * f * f
    return 8 * (n1 * n1 + n1 * n2 + n2 * n2)


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------


def measure_kernel(name, label, call, plain, nbytes, flops, library=None):
    got = call()
    want = plain()
    torch.cuda.synchronize()
    err, scale = max_err(got, want)
    check(err <= KERNEL_TOL * scale,
          f"{label}: kernel vs plain max|Δ| {err:.3e} > {KERNEL_TOL}·{scale:.3e}")
    del got, want
    ms = time_ms(call)
    plain_ms = time_ms(plain)
    lib_ms = time_ms(library) if library is not None else None
    b_ms, b_by = bound_ms(nbytes, flops)
    row = {
        "name": name, "shape": label, "max_abs_err": err, "rel_err": err / scale,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib_ms,
    }
    print("kernel " + json.dumps(row), flush=True)
    return row


def kernel_phase(gen) -> dict:
    """Every kernel at main-path shapes; returns its representative row."""
    dev = ops.device_key("cuda")
    rows = {}

    # 1. dft_matmul: the n = 1024 direct leaf.
    n, b = 1024, 16384
    x = planes(gen, b, n)
    w = ops._direct_luts(dev, n, False)
    xc = torch.complex(*x)
    rows["dft_matmul"] = measure_kernel(
        "dft_matmul", f"B={b} N={n}",
        lambda: dft_matmul.dft_matmul_call(*x, *w),
        lambda: dft_matmul.dft_matmul_plain(*x, *w),
        nbytes=16 * b * n + 8 * n * n, flops=b * transform_flops("direct", n, 0, 0),
        library=lambda: torch.fft.fft(xc),
    )
    del x, xc

    # 2. fft4step: the fused leaves, natural and k1-major order.
    for n, b in ((4096, 4096), (16384, 4096), (65536, 1024)):
        x = planes(gen, b, n)
        luts = ops._fused_luts(dev, *plan_lib.balanced_split(n), False)
        n1, n2 = luts[0].shape[0], luts[4].shape[0]
        xc = torch.complex(*x)
        for natural in (True, False):
            row = measure_kernel(
                "fft4step", f"B={b} n={n} ({n1}x{n2}) {'natural' if natural else 'k1-major'}",
                lambda: fft4step.fft4step_call(*x, *luts, natural_order=natural),
                lambda: fft4step.fft4step_plain(*x, *luts, natural_order=natural),
                nbytes=16 * b * n + lut_bytes("fused4", n, n1, n2),
                flops=b * transform_flops("fused4", n, n1, n2),
                library=(lambda: torch.fft.fft(xc)) if natural else None,
            )
            if n == 16384 and natural:
                rows["fft4step"] = row
        del x, xc

    # 3./4. the pencil passes of each two-pass main-path program.
    for n, b in MAIN_PATH:
        fft_plan = plan_lib.plan_fft(n)
        if len(fft_plan.passes) != 2:
            continue
        x = planes(gen, b, n)
        cols, rows_p = fft_plan.passes
        # Column pass: (B, f0, s) view, inter-factor twiddle epilogue.
        _, s, f = cols.view_in
        luts = ops._transform_luts(dev, cols, False)
        tw = ops._pass_twiddle_luts(dev, *cols.twiddle_after, False)
        xv = (x[0].view(b, f, s), x[1].view(b, f, s))
        kw = dict(kind=cols.kind, n1=cols.n1, n2=cols.n2)
        row = measure_kernel(
            "cols_pass", f"n={n} B={b} (R={b}, f={f}, s={s}) {cols.kind}",
            lambda: pencil.cols_pass_call(*xv, luts, tw, **kw),
            lambda: pencil.cols_pass_plain(*xv, luts, tw, **kw),
            nbytes=16 * b * n + 8 * f * s + lut_bytes(cols.kind, f, cols.n1, cols.n2),
            flops=b * s * transform_flops(cols.kind, f, cols.n1, cols.n2) + 6 * b * n,
        )
        if n == 1 << 22:
            rows["cols_pass"] = row
        # Row pass: (B, p, f) → (B, f, p) transposed write.
        p_, _, f = rows_p.view_in
        luts = ops._transform_luts(dev, rows_p, False)
        xv = (x[0].view(b, p_, f), x[1].view(b, p_, f))
        kw = dict(kind=rows_p.kind, n1=rows_p.n1, n2=rows_p.n2)
        row = measure_kernel(
            "rows_natural", f"n={n} B={b} (B={b}, p={p_}, f={f}) {rows_p.kind}",
            lambda: pencil.rows_natural_call(*xv, luts, **kw),
            lambda: pencil.rows_natural_plain(*xv, luts, **kw),
            nbytes=16 * b * n + lut_bytes(rows_p.kind, f, rows_p.n1, rows_p.n2),
            flops=b * p_ * transform_flops(rows_p.kind, f, rows_p.n1, rows_p.n2),
        )
        if n == 1 << 22:
            rows["rows_natural"] = row
        del x, xv
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 3: the planned main path
# ---------------------------------------------------------------------------


def check_launches(label: str, before: dict, after: dict, expect: dict) -> None:
    """Every counter moved by exactly ``expect`` (kernel → launches) from
    ``before`` to ``after``; plain versions and other kernels by 0."""
    for key in after:
        delta = after[key] - before[key]
        want = 0 if key.endswith("_plain") else expect.get(key, 0)
        check(delta == want, f"{label}: {key} moved by {delta}, expected {want}")


def launches_per_call(planned, calls: int = 1) -> dict:
    expect = {}
    for k in planned.kernels:
        expect[k] = expect.get(k, 0) + calls
    return expect


def counted_call(label: str, planned, x):
    """One planned call, held to exactly ``len(planned.passes)`` launches;
    returns its output and the bytes the call held on the card beyond what
    was allocated before it (output included)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    before = kernels.counts()
    y = planned(x)
    torch.cuda.synchronize()
    check_launches(label, before, kernels.counts(), launches_per_call(planned))
    return y, torch.cuda.max_memory_allocated() - base


def main_path_phase(gen) -> None:
    reps, warmup = 3, 1
    for n, b in MAIN_PATH:
        fwd = F.plan(F.FFTSpec(n))
        inv = F.plan(F.FFTSpec(n, kind="ifft"))
        check(fwd.device.type == "cuda" and fwd.backend.name == "cuda", f"n={n}: plan is not on the card")
        x = torch.complex(*planes(gen, b, n))
        at_start = kernels.counts()

        y, peak = counted_call(f"n={n} fft", fwd, x)
        check(tuple(y.shape) == (b, n) and y.dtype == torch.complex64, f"n={n}: output {y.shape} {y.dtype}")
        check(bool(torch.isfinite(torch.view_as_real(y)).all()), f"n={n}: non-finite output")

        sample = sorted({0, b - 1})
        ref = np.fft.fft(x[sample].cpu().numpy().astype(np.complex128), axis=-1)
        err = np.abs(y[sample].cpu().numpy() - ref).max()
        scale = np.abs(ref).max()
        check(err <= FFT_TOL * scale, f"n={n}: fft vs np.fft {err:.3e} > {FFT_TOL}·{scale:.3e}")

        z, _ = counted_call(f"n={n} ifft", inv, y)
        rt = (z - x).abs().max().item()
        xs = x.abs().max().item()
        check(rt <= FFT_TOL * xs, f"n={n}: ifft(fft(x)) off by {rt:.3e} > {FFT_TOL}·{xs:.3e}")
        del y, z

        fwd_ms = time_ms(lambda: fwd(x), reps=reps, warmup=warmup)
        inv_ms = time_ms(lambda: inv(x), reps=reps, warmup=warmup)
        # Every call of this shape, checked and timed, launched its plan's
        # kernels and nothing else.
        expect = launches_per_call(fwd, 1 + warmup + reps)
        for k, c in launches_per_call(inv, 1 + warmup + reps).items():
            expect[k] = expect.get(k, 0) + c
        check_launches(f"n={n} all calls", at_start, kernels.counts(), expect)
        lib_ms = time_ms(lambda: torch.fft.fft(x), reps=reps, warmup=warmup)  # the yardstick only
        print(
            "main_path " + json.dumps({
                "n": n, "batch": b, "passes": len(fwd.passes), "kernels": list(fwd.kernels),
                "fft_rel_err": float(err / scale), "roundtrip_rel_err": rt / xs,
                "fft_ms": fwd_ms, "ifft_ms": inv_ms, "library_ms": lib_ms,
                "input_bytes": x.numel() * x.element_size(), "fft_call_peak_bytes": peak,
            }),
            flush=True,
        )
        del x
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 4: offsets past 2^31
# ---------------------------------------------------------------------------

#: (n, batch) with batch·n just past 2^31 elements per plane, so every
#: kernel addresses beyond a 32-bit offset: the fused leaf with its scratch
#: slab, and both pencil passes of a direct-leaf program.
BIG_OFFSETS = ((65536, 32769), (1 << 20, 2049))


def offsets_phase(gen) -> None:
    for n, b in BIG_OFFSETS:
        planned = F.plan(F.FFTSpec(n))
        xr, xi = planes(gen, b, n)  # planes in, planes out: 8 GB each
        (yr, yi), peak = counted_call(f"n={n} B={b}", planned, (xr, xi))
        sample = [0, b // 2, b - 1]
        x = (xr[sample].double() + 1j * xi[sample].double()).cpu().numpy()
        ref = np.fft.fft(x, axis=-1)
        got = (yr[sample].double() + 1j * yi[sample].double()).cpu().numpy()
        err = np.abs(got - ref).max()
        scale = np.abs(ref).max()
        check(err <= FFT_TOL * scale, f"n={n} B={b}: rows past 2^31 off by {err:.3e}")
        print("offsets " + json.dumps({
            "n": n, "batch": b, "elements_per_plane": b * n, "kernels": list(planned.kernels),
            "fft_rel_err": float(err / scale),
            "input_bytes": 8 * b * n, "call_peak_bytes": peak,
        }), flush=True)
        del xr, xi, yr, yi
        torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs the card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full fp32
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind} | nvidia-smi: {smi} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    info = build.build()  # every csrc/*.cu, one nvcc each, in parallel
    build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s (compiled={info['compiled']}) {info['path']}", flush=True)
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "Function properties" in line:
            print("ptxas: " + line.strip(), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    try:
        rows = kernel_phase(gen)
        kernels.reset_counts()  # the main path's launches only
        main_path_phase(gen)
        launches = kernels.counts()
        for name in SOURCES:
            check(launches[name] > 0, f"{name} was not launched on the main path")
            check(launches[f"{name}_plain"] == 0, f"{name}'s plain version ran on the main path")
        offsets_phase(gen)
    except SmokeFailure as err:
        print(f"chip_smoke: FAILED: {err}", file=sys.stderr)
        return 1

    out = []
    for name, (source, replaces) in SOURCES.items():
        r = rows[name]
        out.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": r["shape"],
        })
    print(json.dumps({"kernels": out}), flush=True)
    print(smi, flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
