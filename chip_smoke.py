"""Quickest proof that the PyTorch/CUDA port runs on the card.

    python3 chip_smoke.py

Drives the port only (``src/repro_torch``; nothing of JAX or of the JAX
package), in phases, and fails on the first check that does not hold:

1. device — the card's name and power limit, and the build of every kernel
   from ``src/repro_torch/csrc`` (its wall time);
2. kernels — each of the seven CUDA kernels at the shapes the main paths
   give it, against its plain PyTorch version on the same inputs
   (max|Δ| ≤ 1e-4·max|plain|), with its time, the plain version's, its bound
   (the larger of bytes over HBM bandwidth and flops over the FP32 peak)
   and, where one library call computes the same function, that call's time;
3. main path — ``plan(FFTSpec(n))`` forward and ``ifft`` at full-size
   remote-sensing shapes: sample rows against ``np.fft`` in complex128 at
   1e-3·max|ref|, ``ifft(fft(x)) ≈ x``, exactly ``len(plan.passes)`` kernel
   launches and no plain call in every planned call (checked and timed), the
   time per call beside one ``torch.fft.fft`` call (the library yardstick),
   and the device memory one forward call holds beyond its input;
4. offsets — two planned calls with just over 2^31 elements per plane,
   sample rows against ``np.fft``: the kernels' 64-bit addressing, and the
   device memory each call holds (planes in and out, scratch slab);
5. real and 2-D path — ``rfft``/``irfft``, ``fft2``/``ifft2`` (whole and
   strip-mined columns), ``rfft2``/``irfft2`` and ``fft`` down ``axis=-2``
   at 0.5–2 GB each, held as phase 3 holds its calls (sample rows or
   columns against ``np.fft`` in complex128, the inverse back to the input,
   exact launches), timed beside the matching ``torch.fft`` call.

Phases 3 and 5 each set the launch counts to 0 before they start and read
them when they end; every kernel of a path must have launched in it.  The
script then prints the per-kernel JSON line, the ``nvidia-smi`` line, and
last ``{"ok": true, "device": {...}}``.  Without a CUDA device it exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
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
    "cols_natural": ("src/repro_torch/csrc/pencil.cu", "src/repro/kernels/pencil.py:234"),
    "rfft_recomb": ("src/repro_torch/csrc/recomb.cu", "src/repro/kernels/pencil.py:313"),
    "irfft_recomb": ("src/repro_torch/csrc/recomb.cu", "src/repro/kernels/pencil.py:324"),
}

#: The kernels each planned path must launch: phase 3 (1-D complex) and
#: phase 5 (real and 2-D).
PATH_KERNELS = {
    "main_path": ("dft_matmul", "fft4step", "cols_pass", "rows_natural"),
    "real2d": ("fft4step", "cols_pass", "rows_natural", "cols_natural", "rfft_recomb",
               "irfft_recomb"),
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
    rows.update(real2d_kernels(gen, dev))
    return rows


def recomb_flops(points: int) -> int:
    """fp32 flops of the recombination: per output element 4 sums and 4
    halvings of E and O, 6 for w·O and 2 for the final add."""
    return 16 * points


def real2d_kernels(gen, dev) -> dict:
    """The new kernels of the real and 2-D path at the shapes phase 5 gives
    them (and cols_natural's four-step form, which no phase-5 shape reaches
    at a size that fits the time limit)."""
    rows = {}
    # rfft2 of a 16384 x 16384 image: 16384 rows of m = 8192 packed bins.
    b, m = 16384, 8192
    z = planes(gen, b, m)
    w = ops.recomb_luts(dev, 2 * m, False)
    rows["rfft_recomb"] = measure_kernel(
        "rfft_recomb", f"B={b} m={m}",
        lambda: pencil.rfft_recomb_call(*z, *w),
        lambda: pencil.rfft_recomb_plain(*z, *w),
        nbytes=8 * b * m + 8 * b * (m + 1) + 8 * (m + 1), flops=recomb_flops(b * (m + 1)),
    )
    del z
    x = planes(gen, b, m + 1)
    w = ops.recomb_luts(dev, 2 * m, True)
    rows["irfft_recomb"] = measure_kernel(
        "irfft_recomb", f"B={b} m={m}",
        lambda: pencil.irfft_recomb_call(*x, *w),
        lambda: pencil.irfft_recomb_plain(*x, *w),
        nbytes=8 * b * (m + 1) + 8 * b * m + 8 * (m + 1), flops=recomb_flops(b * m),
    )
    del x

    # The strip-mined columns of a (131072, 2048) image: the strided factor
    # with its twiddle broadcast over the width, then the digit-transposing
    # last factor.
    n, n2 = 2048, 1 << 17
    strided, last = plan_lib.plan_fft2(n, n2).passes[1:]
    _, stride, f = strided.view_in
    x = planes(gen, 1, f, stride * n)
    luts = ops._transform_luts(dev, strided, False)
    tw = ops._pass_twiddle_luts(dev, *strided.twiddle_after, False)
    kw = dict(kind=strided.kind, n1=strided.n1, n2=strided.n2, tw_every=n)
    measure_kernel(
        "cols_pass", f"fft2 {n2}x{n} strided factor (R=1, f={f}, s={stride}x{n}) "
        f"{strided.kind} tw_every={n}",
        lambda: pencil.cols_pass_call(*x, luts, tw, **kw),
        lambda: pencil.cols_pass_plain(*x, luts, tw, **kw),
        nbytes=16 * n * n2 + 8 * f * stride + lut_bytes(strided.kind, f, 0, 0),
        flops=stride * n * transform_flops(strided.kind, f, 0, 0) + 6 * n * n2,
    )
    del x
    pencils, _, f = last.view_in
    x = planes(gen, 1, pencils, f, n)
    luts = ops._transform_luts(dev, last, False)
    kw = dict(kind=last.kind, n1=last.n1, n2=last.n2)
    rows["cols_natural"] = measure_kernel(
        "cols_natural", f"fft2 {n2}x{n} last factor (B=1, P={pencils}, f={f}, w={n}) {last.kind}",
        lambda: pencil.cols_natural_call(*x, luts, **kw),
        lambda: pencil.cols_natural_plain(*x, luts, **kw),
        nbytes=16 * n * n2 + lut_bytes(last.kind, f, 0, 0),
        flops=pencils * n * transform_flops(last.kind, f, 0, 0),
    )
    del x
    pp, f, w = 2048, 2048, 32
    n1, n2_ = plan_lib.balanced_split(f)
    x = planes(gen, 1, pp, f, w)
    luts = ops._fused_luts(dev, n1, n2_, False)
    kw = dict(kind="fused4", n1=n1, n2=n2_)
    measure_kernel(
        "cols_natural", f"(B=1, P={pp}, f={f}, w={w}) fused4",
        lambda: pencil.cols_natural_call(*x, luts, **kw),
        lambda: pencil.cols_natural_plain(*x, luts, **kw),
        nbytes=16 * pp * f * w + lut_bytes("fused4", f, n1, n2_),
        flops=pp * w * transform_flops("fused4", f, n1, n2_),
    )
    del x

    # rfft2's column pass over the m + 1 = 8193 bins of a 16384 x 16384
    # image: a ragged width in the fused column kernel, beside the width
    # 8192 that has no ragged chunk.
    r, f = 1, 16384
    n1, n2_ = plan_lib.balanced_split(f)
    luts = ops._fused_luts(dev, n1, n2_, False)
    kw = dict(kind="fused4", n1=n1, n2=n2_)
    for s_ in (8193, 8192):
        x = planes(gen, r, f, s_)
        xc = torch.complex(*x)
        measure_kernel(
            "cols_pass", f"rfft2 columns (R={r}, f={f}, s={s_}) fused4"
            + (" ragged" if s_ % pencil.CHUNK else ""),
            lambda: pencil.cols_pass_call(*x, luts, **kw),
            lambda: pencil.cols_pass_plain(*x, luts, **kw),
            nbytes=16 * r * f * s_ + lut_bytes("fused4", f, n1, n2_),
            flops=r * s_ * transform_flops("fused4", f, n1, n2_),
            library=lambda: torch.fft.fft(xc, dim=-2),
        )
        del x, xc
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


# ---------------------------------------------------------------------------
# phase 5: the real and 2-D path
# ---------------------------------------------------------------------------

#: (forward spec, inverse spec, input shape): 0.5–2 GB each.  rfft at 16384
#: points is one SAR range line block; 2^21 takes the two-pass inner
#: program; the 16384² image is one spotlight scene; the 131072-line image
#: strip-mines its columns; axis=-2 is the azimuth pass of a range block.
REAL_2D = (
    (F.FFTSpec(16384, kind="rfft"), F.FFTSpec(16384, kind="irfft"), (8192, 16384)),
    (F.FFTSpec(1 << 21, kind="rfft"), F.FFTSpec(1 << 21, kind="irfft"), (64, 1 << 21)),
    (F.FFTSpec(16384, kind="fft2", n2=16384), F.FFTSpec(16384, kind="ifft2", n2=16384),
     (1, 16384, 16384)),
    (F.FFTSpec(2048, kind="fft2", n2=1 << 17), F.FFTSpec(2048, kind="ifft2", n2=1 << 17),
     (1, 1 << 17, 2048)),
    (F.FFTSpec(16384, kind="rfft2", n2=16384), F.FFTSpec(16384, kind="irfft2", n2=16384),
     (1, 16384, 16384)),
    (F.FFTSpec(16384, axis=-2), F.FFTSpec(16384, kind="ifft", axis=-2), (16384, 4096)),
)


def as_complex(y):
    return torch.complex(*y) if isinstance(y, tuple) else y


def row_dft(x, ks, n: int) -> np.ndarray:
    """Σ_j x[r, j]·e^{−2πi·j·k/n} for each row r and sample frequency k, in
    complex128 on the card: the rows' DFT at ``ks`` only, (rows, len(ks))."""
    j = torch.arange(n, device=x.device, dtype=torch.int64)
    phase = torch.outer(j, torch.tensor(ks, device=x.device, dtype=torch.int64)) % n
    ang = phase.to(torch.float64) * (-2 * math.pi / n)
    w = torch.polar(torch.ones_like(ang), ang)
    out = [x[r:r + 1024].to(torch.complex128) @ w for r in range(0, x.shape[0], 1024)]
    return torch.cat(out).cpu().numpy()


def sample_check(spec, x, y) -> float:
    """The forward output at sample rows (1-D) or columns (2-D, axis=-2)
    against np.fft in complex128; returns max|Δ| / max|ref|."""
    if spec.kind == "rfft":
        rows = [0, x.shape[0] - 1]
        ref = np.fft.rfft(x[rows].double().cpu().numpy(), axis=-1)
        got = as_complex(y)[rows]
    elif spec.axis == -2:
        cols = [0, 1, x.shape[-1] - 1]
        ref = np.fft.fft(x[:, cols].cpu().numpy().astype(np.complex128), axis=0)
        got = y[:, cols]
    else:
        # Column k of fft2/rfft2 is the column FFT of the rows' DFT at k.
        n = spec.n
        ks = [0, 1, 3 * n // 8 + 1, n // 2] + ([n - 1] if spec.kind == "fft2" else [])
        ref = np.fft.fft(row_dft(x[0], ks, n), axis=0)
        got = as_complex(y)[0][:, ks]
    err = np.abs(got.cpu().numpy().astype(np.complex128) - ref).max()
    return float(err / np.abs(ref).max())


def real2d_phase(gen) -> None:
    reps, warmup = 3, 1
    library = {
        "rfft": lambda x: torch.fft.rfft(x),
        "irfft": lambda y, n: torch.fft.irfft(y, n=n),
        "fft2": lambda x: torch.fft.fft2(x),
        "ifft2": lambda y, n: torch.fft.ifft2(y),
        "rfft2": lambda x: torch.fft.rfft2(x),
        "irfft2": lambda y, n: torch.fft.irfft2(y, s=(y.shape[-2], n)),
        "fft": lambda x: torch.fft.fft(x, dim=-2),
        "ifft": lambda y, n: torch.fft.ifft(y, dim=-2),
    }
    for fspec, ispec, shape in REAL_2D:
        fwd, inv = F.plan(fspec), F.plan(ispec)
        label = f"{fspec.kind} {'x'.join(map(str, shape))}" + (" axis=-2" if fspec.axis == -2 else "")
        check(fwd.device.type == "cuda" and inv.device.type == "cuda", f"{label}: plan is not on the card")
        if fspec.kind.startswith("r"):
            x = torch.randn(*shape, device="cuda", generator=gen)
        else:
            x = torch.complex(*planes(gen, *shape))
        at_start = kernels.counts()

        y, peak = counted_call(f"{label} forward", fwd, x)
        yc = as_complex(y)
        check(bool(torch.isfinite(torch.view_as_real(yc)).all()), f"{label}: non-finite output")
        err = sample_check(fspec, x, y)
        check(err <= FFT_TOL, f"{label}: vs np.fft {err:.3e} > {FFT_TOL}·max|ref|")
        z, _ = counted_call(f"{label} inverse", inv, y)
        rt = (z - x).abs().max().item()
        xs = x.abs().max().item()
        check(tuple(z.shape) == tuple(x.shape), f"{label}: inverse gives {tuple(z.shape)}")
        check(rt <= FFT_TOL * xs, f"{label}: inverse off by {rt:.3e} > {FFT_TOL}·{xs:.3e}")
        del z

        fwd_ms = time_ms(lambda: fwd(x), reps=reps, warmup=warmup)
        inv_ms = time_ms(lambda: inv(y), reps=reps, warmup=warmup)
        expect = launches_per_call(fwd, 1 + warmup + reps)
        for k, c in launches_per_call(inv, 1 + warmup + reps).items():
            expect[k] = expect.get(k, 0) + c
        check_launches(f"{label} all calls", at_start, kernels.counts(), expect)
        n = fspec.n
        lib_fwd = library[fspec.kind]
        lib_inv = library[ispec.kind]
        lib_fwd_ms = time_ms(lambda: lib_fwd(x), reps=reps, warmup=warmup)
        lib_inv_ms = time_ms(lambda: lib_inv(yc, n), reps=reps, warmup=warmup)
        print(
            "real2d " + json.dumps({
                "call": label, "inverse": ispec.kind, "passes": len(fwd.passes),
                "kernels": list(fwd.kernels), "inverse_kernels": list(inv.kernels),
                "rel_err": err, "roundtrip_rel_err": rt / xs,
                "ms": fwd_ms, "inverse_ms": inv_ms,
                "library_ms": lib_fwd_ms, "library_inverse_ms": lib_inv_ms,
                "input_bytes": x.numel() * x.element_size(), "call_peak_bytes": peak,
            }),
            flush=True,
        )
        del x, y, yc
        torch.cuda.empty_cache()


def path_launches(name: str, phase, gen) -> dict:
    """Drive one path with the counts at 0; every kernel of the path must
    launch in it and no plain version may run."""
    kernels.reset_counts()
    phase(gen)
    launches = kernels.counts()
    for kernel in PATH_KERNELS[name]:
        check(launches[kernel] > 0, f"{kernel} was not launched on the {name} path")
    for key, count in launches.items():
        check(not key.endswith("_plain") or count == 0, f"{key} ran on the {name} path")
    print(f"{name}_launches " + json.dumps(launches), flush=True)
    return launches


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
        main = path_launches("main_path", main_path_phase, gen)
        offsets_phase(gen)
        real2d = path_launches("real2d", real2d_phase, gen)
        launches = {name: main[name] + real2d[name] for name in SOURCES}
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
