"""Time the whole-signal kernels (``dft_matmul``, ``fft4step``), the
split-regime and 2-D column passes (``cols_pass``, ``rows_natural``,
``cols_natural``), the fused Bluestein stages (``bluestein_fwd``,
``bluestein_inv``) and the elementwise kernels (``bluestein_elem``, the
recombination) of one tree of this repository on the card, back to back.

    python3 scripts/kernel_ab.py <tree> [label] [--forms]

``<tree>`` is an unpacked checkout (``git archive``) of this repository, of
this commit or an earlier one: the script imports that tree's
``repro_torch``, builds its kernels into the tree's own ``build/``, and
calls each kernel's wrapper with that tree's LUTs (the DFT matrices of the
GEMM kernels before their radix redesign, the roots table after it; for
the Bluestein stages ``ops._bluestein_luts`` of the tree, with its
wrappers' keywords) at the shapes ``chip_smoke.py``'s phase 2 gives them
(``cols_natural`` on a tree before its redesign through that tree's
``ops._transform_luts``).  A kernel's time is the
median over 5 batches of the mean of 20 back-to-back calls between two
CUDA events, so the wrappers' host time hides behind the queued launches
(``chip_smoke.py`` times one call per event pair, which adds it).  Each
output is checked against ``torch.fft`` first.  Prints one JSON line per
(kernel, shape, form), one per fused Bluestein call of ``chip_smoke.py``'s
phase 6 with the device memory a warm call requests beyond its input
(``requested_bytes``: the tensors' own bytes, which the caching
allocator's rounding of reused blocks does not move) and allocates, and
the card's name and power limit.

``--forms`` (a tree whose passes are radix FFTs): also time every form each
pass shape can take (each on-chip tile of 2^12, 2^13, 2^14 points that
holds f, and the four-step through the scratch slab from f = 1024), beside
the form the tree's tables pick (``"default": true``); ``cols_natural``
too on a tree where it is one.

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

#: (kernel, batch, n, orders): phase 2's shapes of the two whole-signal kernels.
SHAPES = (
    ("dft_matmul", 16384, 1024, ("natural",)),
    ("fft4step", 4096, 4096, ("natural", "k1-major")),
    ("fft4step", 4096, 16384, ("natural", "k1-major")),
    ("fft4step", 1024, 65536, ("natural", "k1-major")),
)

#: (n, batch): the two-pass programs whose column and row passes phase 2
#: times (n = 2^18 is phase 6's split-regime pad of n = 100003).
PAIRS = ((1 << 18, 64), (1 << 20, 64), (1 << 22, 16), (1 << 24, 4), (1 << 26, 2))

#: (batch, n): phase 2's shapes of the fused Bluestein stages.
BLUESTEIN = ((16384, 500), (131072, 500), (8192, 3000), (4096, 3000), (2048, 12288), (8192, 4999))

#: (kind, n, n2, axis, input shape): phase 6's calls through the fused
#: Bluestein stages.
CALLS = (
    ("fft", 500, None, -1, (16384, 500)), ("fft", 3000, None, -1, (8192, 3000)),
    ("fft", 12288, None, -1, (2048, 12288)), ("rfft", 4999, None, -1, (8192, 4999)),
    ("rfft", 6000, None, -1, (8192, 6000)), ("fft2", 3000, 4096, -1, (1, 4096, 3000)),
    ("fft2", 500, 1 << 17, -1, (1, 1 << 17, 500)), ("fft", 3000, None, -2, (3000, 4096)),
)

#: (label, P, f, w): phase 2's shapes of ``cols_natural`` (B = 1): the
#: last factors of strip-mined fft2 columns, the 2^14-tile and slab rows.
NATURAL = (
    ("fft2 131072x2048 last factor", 512, 256, 2048),
    ("fft2 131072x500 last factor", 512, 256, 500),
    ("phase 2", 2048, 2048, 32),
    ("phase 2", 256, 4096, 64),
)

#: (batch, m): phase 2's shapes of the recombination.
RECOMB = ((16384, 8192), (8192, 3000))

#: (label, f, s, tw_every): phase 2's other column-pass shapes (R = 1):
#: the strided factors of strip-mined fft2 columns (twiddle broadcast over
#: runs of tw_every columns) and whole columns (no twiddle).
COLUMNS = (
    ("fft2 131072x2048 strided factor", 512, 256 * 2048, 2048),
    ("fft2 131072x500 strided factor", 512, 256 * 500, 500),
    ("rfft2 16384^2 columns", 16384, 8193, 0),
    ("rfft2 16384^2 columns", 16384, 8192, 0),
    ("fft axis=-2 (16384, 4096) columns", 16384, 4096, 0),
    ("fft2 (4096, 3000) columns", 4096, 3000, 0),
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


def rel_err(got, want) -> float:
    return ((torch.complex(*got) - want).abs().max() / want.abs().max()).item()


def whole_signal(label, plan_lib, dft_matmul, fft4step, ops, dev, gen) -> bool:
    radix = hasattr(ops, "_roots_luts")
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
            want = ref if natural else ref.view(b, n2, n1).transpose(1, 2).reshape(b, n)
            err = rel_err(call(), want)
            if not err <= 1e-3:
                print(f"kernel_ab: {kernel} n={n} {order} off by {err:.3e}", file=sys.stderr)
                return False
            print(json.dumps({
                "tree": label, "kernel": kernel, "batch": b, "n": n, "order": order,
                "ms": time_ms(call), "bytes": 16 * b * n, "rel_err": err,
            }), flush=True)
        del xr, xi, ref
        torch.cuda.empty_cache()
    return True


def pass_cases(plan_lib):
    """(kernel, shape label, x shape, f, the planner's n1, twiddle shape or
    None, tw_every) of every pass shape phase 2 times."""
    for n, b in PAIRS:
        cols, rows = plan_lib.plan_fft(n).passes
        _, s, f = cols.view_in
        yield "cols_pass", f"n={n} B={b}", (b, f, s), f, cols.n1, (f, s), 1
        p, _, f = rows.view_in
        yield "rows_natural", f"n={n} B={b}", (b, p, f), f, rows.n1, None, 1
    for label, f, s, tw_every in COLUMNS:
        n1 = plan_lib.balanced_split(f)[0] if f > 1024 else 0
        tw = (f, s // tw_every) if tw_every else None
        yield "cols_pass", label, (1, f, s), f, n1, tw, max(tw_every, 1)


def form_calls(pencil, table, f: int, forms: bool, launch) -> dict:
    """{form name: (call, whether ``table`` picks it)}: the default form of
    length f, or with ``forms`` every on-chip tile that holds f and the slab
    from :data:`pencil.SLAB_MIN_F`; ``launch(tile)`` makes the call."""
    default = table[f.bit_length() - 1]
    tiles = [t for t in (12, 13, 14) if f <= 1 << t]
    if f >= pencil.SLAB_MIN_F:
        tiles.append(pencil.SLAB)
    tiles = tiles if forms else [default]
    return {"slab" if t == pencil.SLAB else f"tile 2^{t}": (launch(t), t == default)
            for t in tiles}


def passes(label, plan_lib, pencil, ops, dev, gen, forms: bool) -> bool:
    radix = hasattr(pencil, "COLS_TILE")
    for kernel, shape, xs, f, n1, tws, tw_every in pass_cases(plan_lib):
        xr = torch.randn(*xs, device="cuda", generator=gen)
        xi = torch.randn(*xs, device="cuda", generator=gen)
        tw = None
        if tws is not None:
            ang = torch.rand(*tws, device="cuda", generator=gen) * 6.283185307179586
            tw = (torch.cos(ang), torch.sin(ang))
        x = torch.complex(xr, xi)
        if kernel == "cols_pass":
            want = torch.fft.fft(x, dim=-2)
            if tw is not None:
                want = want * torch.complex(*tw).repeat_interleave(tw_every, dim=1)
        else:
            want = torch.fft.fft(x, dim=-1).transpose(1, 2)
        del x
        if radix:
            w = ops._roots_luts(dev, f, False)
            table = pencil.COLS_TILE if kernel == "cols_pass" else pencil.ROWS_TILE
            if kernel == "cols_pass":
                def launch(t):
                    return lambda: pencil._launch_cols(xr, xi, *w, tw, False, n1, tw_every, t)
            else:
                def launch(t):
                    return lambda: pencil._launch_rows(xr, xi, *w, False, n1, t)
            named = form_calls(pencil, table, f, forms, launch)
        else:
            kind = "direct" if f <= 1024 else "fused4"
            n1_, n2_ = (0, 0) if kind == "direct" else plan_lib.balanced_split(f)
            luts = ops._transform_luts(dev, plan_lib.Pass(kind=kind, n=f, n1=n1_, n2=n2_), False)
            kw = dict(kind=kind, n1=n1_, n2=n2_)
            if kernel == "cols_pass":
                if tw_every > 1:
                    kw["tw_every"] = tw_every
                call = lambda: pencil.cols_pass_call(xr, xi, luts, tw, **kw)  # noqa: E731
            else:
                call = lambda: pencil.rows_natural_call(xr, xi, luts, **kw)  # noqa: E731
            named = {"parent": (call, True)}
        for form, (call, is_default) in named.items():
            err = rel_err(call(), want)
            if not err <= 1e-3:
                print(f"kernel_ab: {kernel} {shape} {form} off by {err:.3e}", file=sys.stderr)
                return False
            print(json.dumps({
                "tree": label, "kernel": kernel, "shape": shape, "view": list(xs), "f": f,
                "form": form, "default": is_default, "ms": time_ms(call),
                "bytes": 16 * xr.numel() + (8 * tws[0] * tws[1] if tws else 0), "rel_err": err,
            }), flush=True)
        del xr, xi, tw, want, named
        torch.cuda.empty_cache()
    return True


def natural(label, plan_lib, pencil, ops, dev, gen, forms: bool) -> bool:
    """``cols_natural`` at each of :data:`NATURAL`'s shapes, against
    ``torch.fft`` first.  A tree before its redesign calls it with
    ``ops._transform_luts`` and the pass's kind; a radix tree with the
    roots table, in each form with ``forms``."""
    import inspect

    old = "kind" in inspect.signature(pencil.cols_natural_call).parameters
    for shape, pp, f, w in NATURAL:
        xr = torch.randn(1, pp, f, w, device="cuda", generator=gen)
        xi = torch.randn(1, pp, f, w, device="cuda", generator=gen)
        want = torch.fft.fft(torch.complex(xr, xi), dim=2).permute(0, 2, 1, 3)
        if old:
            kind = "direct" if f <= 1024 else "fused4"
            n1, n2 = (0, 0) if kind == "direct" else plan_lib.balanced_split(f)
            luts = ops._transform_luts(dev, plan_lib.Pass(kind=kind, n=f, n1=n1, n2=n2), False)
            named = {"parent": (lambda: pencil.cols_natural_call(
                xr, xi, luts, kind=kind, n1=n1, n2=n2), True)}
        else:
            rr = ops._roots_luts(dev, f, False)
            n1 = plan_lib.balanced_split(f)[0] if f >= pencil.SLAB_MIN_F else 0

            def launch(t):
                return lambda: pencil._launch_cols_natural(xr, xi, *rr, False, n1, t)
            named = form_calls(pencil, pencil.COLS_TILE, f, forms, launch)
        for form, (call, is_default) in named.items():
            err = rel_err(call(), want)
            if not err <= 1e-3:
                print(f"kernel_ab: cols_natural {shape} {form} off by {err:.3e}", file=sys.stderr)
                return False
            print(json.dumps({
                "tree": label, "kernel": "cols_natural", "shape": shape, "view": [1, pp, f, w],
                "f": f, "form": form, "default": is_default, "ms": time_ms(call),
                "bytes": 16 * xr.numel() + 8 * f, "rel_err": err,
            }), flush=True)
        del xr, xi, want, named
        torch.cuda.empty_cache()
    return True


def elementwise(label, plan_lib, bluestein, pencil, ops, dev, gen) -> bool:
    """The three ``bluestein_elem`` stages at B=64, n=100003 and both
    recombinations at :data:`RECOMB`'s shapes, each against its plain
    version at 1e-4 first: their times without the wrapper's host time
    that ``chip_smoke.py``'s one call per event pair adds."""
    b, n = 64, 100003
    m = plan_lib.bluestein_pad(n)
    cases = []
    for stage in bluestein.STAGES:
        w_in, w_out, w_lut = bluestein._elem_widths(stage, n, m)
        lut = ops._bluestein_luts(dev, plan_lib.Pass(kind="bluestein", n=n, n1=m, stage=stage),
                                  False)
        kw = dict(stage=stage, n=n, m_pad=m)
        cases.append((f"bluestein_elem {stage}", f"B={b} n={n} M={m}", (b, w_in),
                      8 * b * (min(w_in, w_out) + w_out) + 8 * w_lut,  # post reads n of M
                      lambda x, lut=lut, kw=kw: bluestein.bluestein_elem_call(*x, lut, **kw),
                      lambda x, lut=lut, kw=kw: bluestein.bluestein_elem_plain(*x, lut, **kw)))
    for b, m in RECOMB:
        fwd, inv = ops.recomb_luts(dev, 2 * m, False), ops.recomb_luts(dev, 2 * m, True)
        nbytes = 8 * b * (2 * m + 1) + 8 * (m + 1)
        cases.append(("rfft_recomb", f"B={b} m={m}", (b, m), nbytes,
                      lambda x, w=fwd: pencil.rfft_recomb_call(*x, *w),
                      lambda x, w=fwd: pencil.rfft_recomb_plain(*x, *w)))
        cases.append(("irfft_recomb", f"B={b} m={m}", (b, m + 1), nbytes,
                      lambda x, w=inv: pencil.irfft_recomb_call(*x, *w),
                      lambda x, w=inv: pencil.irfft_recomb_plain(*x, *w)))
    for kernel, shape, xs, nbytes, call, plain in cases:
        x = (torch.randn(*xs, device="cuda", generator=gen),
             torch.randn(*xs, device="cuda", generator=gen))
        err = rel_err(call(x), torch.complex(*plain(x)))
        if not err <= 1e-4:
            print(f"kernel_ab: {kernel} {shape} off by {err:.3e}", file=sys.stderr)
            return False
        print(json.dumps({
            "tree": label, "kernel": kernel, "shape": shape, "ms": time_ms(lambda: call(x)),
            "bytes": nbytes, "rel_err": err,
        }), flush=True)
        del x
        torch.cuda.empty_cache()
    return True


def bluestein_stages(label, plan_lib, bluestein, ops, dev, gen) -> bool:
    """Both fused stages at each shape, each against its plain version at
    1e-4 first (the tree's own: the parent's runs the DFT-matrix tiles)."""
    import inspect

    old = "inner_kind" in inspect.signature(bluestein.bluestein_fwd_call).parameters
    for b, n in BLUESTEIN:
        fwd, inv = plan_lib.plan_fft(n).passes
        m = fwd.n1
        inner = plan_lib._leaf_pass(m)
        plain_kw = dict(n=n, m_pad=m)
        if old:
            plain_kw.update(inner_kind=inner.kind, in1=inner.n1, in2=inner.n2)
        call_kw = dict(plain_kw, in1=inner.n1)
        for stage, p, width in (("fwd", fwd, n), ("inv", inv, m)):
            luts = ops._bluestein_luts(dev, p, False)
            xr = torch.randn(b, width, device="cuda", generator=gen)
            xi = torch.randn(b, width, device="cuda", generator=gen)
            call = getattr(bluestein, f"bluestein_{stage}_call")
            got, want = call(xr, xi, luts, **call_kw), getattr(
                bluestein, f"bluestein_{stage}_plain")(xr, xi, luts, **plain_kw)
            err = rel_err(got, torch.complex(*want))
            if not err <= 1e-4:
                print(f"kernel_ab: bluestein_{stage} B={b} n={n} off by {err:.3e}", file=sys.stderr)
                return False
            del got, want
            print(json.dumps({
                "tree": label, "kernel": f"bluestein_{stage}", "batch": b, "n": n, "m": m,
                "ms": time_ms(lambda: call(xr, xi, luts, **call_kw)),
                "bytes": 8 * b * (n + m) + sum(4 * t.numel() for t in luts), "rel_err": err,
            }), flush=True)
            del xr, xi
            torch.cuda.empty_cache()
    return True


def call_peaks(label, F, gen) -> None:
    """The device memory each call of :data:`CALLS` holds beyond its input
    in a warm call (output included)."""
    for kind, n, n2, axis, shape in CALLS:
        planned = F.plan(F.FFTSpec(n, kind=kind, n2=n2, axis=axis))
        x = torch.randn(*shape, device="cuda", generator=gen)
        if kind != "rfft":
            x = torch.complex(x, torch.randn(*shape, device="cuda", generator=gen))
        planned(x)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_stats()
        y = planned(x)
        torch.cuda.synchronize()
        after = torch.cuda.memory_stats()
        print(json.dumps({
            "tree": label, "call": f"{kind} {'x'.join(map(str, shape))}" + (
                " axis=-2" if axis == -2 else ""),
            "input_bytes": x.numel() * x.element_size(),
            "requested_bytes": after["requested_bytes.all.peak"]
            - before["requested_bytes.all.current"],
            "allocated_bytes": after["allocated_bytes.all.peak"]
            - before["allocated_bytes.all.current"],
        }), flush=True)
        del x, y
        torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA device", file=sys.stderr)
        return 2
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    tree = os.path.abspath(args[0])
    label = args[1] if len(args) > 1 else os.path.basename(tree)
    sys.path.insert(0, os.path.join(tree, "src"))
    from repro_torch.core import fft as F
    from repro_torch.core import plan as plan_lib
    from repro_torch.kernels import bluestein, build, dft_matmul, fft4step, ops, pencil

    build.build()
    dev = ops.device_key("cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    if not whole_signal(label, plan_lib, dft_matmul, fft4step, ops, dev, gen):
        return 1
    if not passes(label, plan_lib, pencil, ops, dev, gen, "--forms" in sys.argv):
        return 1
    if not natural(label, plan_lib, pencil, ops, dev, gen, "--forms" in sys.argv):
        return 1
    if not bluestein_stages(label, plan_lib, bluestein, ops, dev, gen):
        return 1
    if not elementwise(label, plan_lib, bluestein, pencil, ops, dev, gen):
        return 1
    call_peaks(label, F, gen)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
