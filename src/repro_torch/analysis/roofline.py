"""Modelled HBM traffic of pass programs and convolutions: the tuner's model.

Port of the planning half of ``repro/analysis/roofline.py``.  Every byte
and flop count is the reference's, unchanged, over the port's copy of the
planner (:mod:`repro_torch.core.plan`), so a report here equals the
reference's report for the same shape.  Only the seconds differ: they
divide by the rates of :data:`H100`, the port's card, where the reference
divides by a TPU v5e's.

The byte account is the reference's, TPU kernels included: a direct leaf
streams its n² DFT matrix and a four-step leaf its three small ones.  The
port's radix kernels read one (n,) roots table instead, so the account
overstates what a direct leaf costs on the card (ROADMAP B queues
re-basing it on the port's kernels).

:func:`pencil_report` models the distributed pencil FFT
(:mod:`repro_torch.core.distributed`): its all-to-all bytes divide by the
card's link rate in one direction, its local bytes by the HBM rate.

The dry run's half: :func:`collective_bytes` reads a trace
(:class:`repro_torch.analysis.trace.TraceCost`) where the reference parses
HLO text, :func:`roofline_terms` divides a cell's flops, bytes and
collective bytes by :data:`H100`'s rates (flops by the peak of their dtype
where given a ``{dtype: flops}`` mapping), :func:`model_flops` is 6·N·D and
:func:`summarize_cell` prints one record.  The reference's models of the
``pallas_gpu`` programs (``gpu_program_report``, ``gpu_plan_report``,
``xla_gpu_fft_bytes``) stay unported: the port has one backend on the card
and no crossover to model.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

__all__ = [
    "HW",
    "H100",
    "COLLECTIVE_LAUNCH_S",
    "fft_pass_report",
    "bluestein_report",
    "prune_candidates",
    "fft2_fallback_report",
    "conv_report",
    "pencil_report",
    "collective_bytes",
    "model_flops",
    "roofline_terms",
    "summarize_cell",
]


@dataclasses.dataclass(frozen=True)
class HW:
    name: str
    peak_flops_bf16: float
    peak_flops_f32: float
    hbm_bw: float
    link_bw: float
    hbm_bytes: float


#: Fixed charge per collective call (seconds), the reference's: the wire
#: bytes are the same whether the split-complex pair rides one stacked
#: all-to-all or two, so without it the model could never prefer packing.
#: It separates "fewer collectives" from "the same bytes", not one card
#: from another.
COLLECTIVE_LAUNCH_S = 10e-6

#: NVIDIA's data sheet for the H100 SXM at its 700 W power limit (dense
#: rates): 989 TFLOP/s bf16, 67 TFLOP/s fp32 on the CUDA cores, 80 GB of
#: HBM3 at 3.35 TB/s.  ``link_bw`` is NVLink 4 in ONE direction: 18 links
#: × 25 GB/s = 450 GB/s (the data sheet's 900 GB/s counts both
#: directions); an all-to-all sends and receives at once, so a rank's
#: outgoing bytes move at the one-direction rate.  A card set below 700 W
#: runs slower under load; these are the published peaks, not a
#: measurement.
H100 = HW(
    name="nvidia-h100-sxm-700w",
    peak_flops_bf16=989e12,
    peak_flops_f32=67e12,
    hbm_bw=3.35e12,
    link_bw=450e9,
    hbm_bytes=80e9,
)


def fft_pass_report(n: int, batch: int = 1, hw: HW = H100, n2: Optional[int] = None) -> dict:
    """Modelled HBM traffic of an FFT's linearized pass program: one entry
    per pass (the plan's HBM round trips), the total and its memory term.
    With ``n2`` the report covers the joint 2-D program of an
    ``(..., n2, n)`` image, each pass charged the whole image it streams."""
    from repro_torch.core import plan as plan_lib  # local: analysis stays lazy

    plan = plan_lib.plan_fft2(n, n2) if n2 is not None else plan_lib.plan_fft(n)
    shape2d = (n2, n) if n2 is not None else None
    passes = []
    for i, p in enumerate(plan.passes):
        nbytes = plan_lib.pass_hbm_bytes(p, batch, plan_lib.pass_other(p, plan))
        pencils, stride, f = p.view_in if p.view_in else (1, 1, p.n)
        passes.append({
            "pass": i,
            "kind": p.kind,
            "axis": p.axis,
            "n": p.n,
            "view": [pencils, stride, f],
            "twiddle": list(p.twiddle_after) if p.twiddle_after else None,
            "order": p.order,
            "hbm_bytes": nbytes,
        })
    total = plan_lib.program_hbm_bytes(plan.passes, batch, shape2d)
    report = {
        "n": n,
        "batch": batch,
        "hbm_round_trips": plan.hbm_round_trips,
        "passes": passes,
        "modeled_hbm_bytes": total,
        "memory_s": total / hw.hbm_bw,
    }
    if n2 is not None:
        report["n2"] = n2
    return report


def bluestein_report(n: int, batch: int = 1, pad: Optional[int] = None, hw: HW = H100) -> dict:
    """Modelled cost of the Bluestein chirp-conv program for a non-pow2
    ``n`` against a hypothetical native mixed-radix transform of the same
    length: two transforms of the pad ``M`` plus the O(n + M) chirp
    multiplies, against 5·n·log₂n flops and one signal round trip — the
    Bluestein tax, per size."""
    from repro_torch.core import limits, plan as plan_lib  # local: analysis stays lazy

    if n > 1 and not (n & (n - 1)):
        raise ValueError(
            f"n={n} is a power of two — it runs the native schedules; the "
            f"Bluestein report covers the non-pow2 route"
        )
    m_pad = limits.bluestein_pad(n) if pad is None else pad
    prog = plan_lib.compile_bluestein(n, pad)
    passes = []
    total = 0
    for i, p in enumerate(prog):
        nbytes = plan_lib.pass_hbm_bytes(p, batch)
        passes.append({"pass": i, "kind": p.kind, "stage": p.stage, "n": p.n, "hbm_bytes": nbytes})
        total += nbytes
    f32 = 4
    log2 = math.log2
    flops = batch * (2 * 5.0 * m_pad * log2(m_pad) + 8.0 * (2 * n + m_pad))
    mixed_flops = batch * 5.0 * n * max(log2(n), 1.0)
    mixed_bytes = 2 * batch * n * 2 * f32  # one signal round trip
    return {
        "n": n,
        "pad": m_pad,
        "batch": batch,
        "pad_ratio": m_pad / n,
        "hbm_round_trips": len(prog),
        "passes": passes,
        "modeled_hbm_bytes": total,
        "memory_s": total / hw.hbm_bw,
        "modeled_flops": flops,
        "mixed_radix_flops": mixed_flops,
        "mixed_radix_hbm_bytes": mixed_bytes,
        "flops_overhead": flops / mixed_flops,
        "hbm_overhead": total / mixed_bytes,
    }


def prune_candidates(candidates: list, tol: float = 0.2, vmem_budget: Optional[int] = None) -> list:
    """Roofline pruning of a tuning space — the model half of the tuner.

    ``candidates``: ordered ``(config, modeled_hbm_bytes, working_set_bytes)``
    triples, the fixed heuristic FIRST.  Keeps the candidates whose working
    set fits the budget (default: the reference's ``VMEM_BUDGET``) and whose
    modelled traffic is within ``tol`` of the feasible minimum, sorted by
    modelled bytes (stable, so the heuristic wins modelled ties).
    """
    from repro_torch.core.limits import VMEM_BUDGET  # local: analysis stays lazy

    budget = VMEM_BUDGET if vmem_budget is None else vmem_budget
    feasible = [c for c in candidates if c[2] <= budget]
    if not feasible:
        feasible = candidates  # degenerate: nothing fits, measure anyway
    floor = min(c[1] for c in feasible)
    kept = [c for c in feasible if c[1] <= floor * (1.0 + tol)]
    return sorted(kept, key=lambda c: c[1])


def fft2_fallback_report(n: int, n2: int, batch: int = 1, hw: HW = H100) -> dict:
    """The joint 2-D program against the per-axis composition it replaced
    (a row plan, then a column plan behind a transpose sandwich when the
    columns take more than one pass): both schedules' modelled bytes."""
    from repro_torch.core import plan as plan_lib  # local: analysis stays lazy

    f32 = 4
    joint_plan = plan_lib.plan_fft2(n, n2)
    joint = plan_lib.program_hbm_bytes(joint_plan.passes, batch, (n2, n))
    row = plan_lib.program_hbm_bytes(plan_lib.plan_fft(n).passes, batch * n2)
    col_passes = plan_lib.plan_fft(n2).passes
    col = plan_lib.program_hbm_bytes(col_passes, batch * n)
    img = batch * n2 * n * 2 * f32  # split-complex image
    transposes = 2 * 2 * img if len(col_passes) > 1 else 0  # swapaxes sandwich
    fallback = row + col + transposes
    return {
        "n": n,
        "n2": n2,
        "batch": batch,
        "joint_hbm_bytes": joint,
        "joint_passes": len(joint_plan.passes),
        "fallback_hbm_bytes": fallback,
        "fallback_transpose_bytes": transposes,
        "bytes_ratio": fallback / joint if joint else float("inf"),
        "joint_memory_s": joint / hw.hbm_bw,
        "fallback_memory_s": fallback / hw.hbm_bw,
    }


def _rfft_conv_bytes(n: int, batch: int, plan_lib) -> int:
    """Modelled HBM traffic of one rfft → ⊙H → irfft pair at length ``n``:
    the packed complex programs (length n/2) at signal batch, the filter's
    forward transform once, the recombination epilogues and the spectrum
    multiply, split-complex float32."""
    f32 = 4
    m = n // 2
    prog = plan_lib.plan_fft(max(m, 1)).passes
    sig_fwd = plan_lib.program_hbm_bytes(prog, batch)
    sig_inv = plan_lib.program_hbm_bytes(prog, batch)
    filt_fwd = plan_lib.program_hbm_bytes(prog, 1)
    recomb = (2 * batch + 1) * (2 * m + 1) * 2 * f32
    cmul_b = (2 * batch + 1) * (m + 1) * 2 * f32
    return sig_fwd + sig_inv + filt_fwd + recomb + cmul_b


def conv_report(L: int, Lh: int, batch: int = 1, hw: HW = H100, block=None) -> dict:
    """One-shot against overlap-save modelled HBM traffic of an FFT
    convolution: the one-shot pad to ``next_pow2(L + Lh − 1)``, and
    overlap-save's ``num_blocks`` blocks of ``block`` samples with the
    framing gather, the tail scatter and the ``block/(block − Lh + 1)``
    redundancy charged explicitly."""
    from repro_torch.core import overlap as ov  # local: analysis stays lazy
    from repro_torch.core import plan as plan_lib
    from repro_torch.core.limits import next_pow2

    f32 = 4
    n_one = next_pow2(L + Lh - 1)
    one_bytes = _rfft_conv_bytes(n_one, batch, plan_lib)
    one = {
        "n": n_one,
        "hbm_round_trips": 2 * plan_lib.plan_fft(n_one // 2).hbm_round_trips,
        "hbm_bytes": one_bytes,
        "memory_s": one_bytes / hw.hbm_bw,
    }

    B = ov.pick_block(Lh, block)
    step = B - (Lh - 1)
    nb = -(-L // step)
    os_bytes = _rfft_conv_bytes(B, batch * nb, plan_lib)
    # Framing gather (read L, write nb·B) + tail scatter (read nb·step,
    # write L), real float32.
    os_bytes += batch * (L + nb * B + nb * step + L) * f32
    osd = {
        "block": B,
        "num_blocks": nb,
        "valid_per_block": step,
        "max_plan_n": B,
        "hbm_bytes": os_bytes,
        "memory_s": os_bytes / hw.hbm_bw,
    }
    return {
        "L": L,
        "Lh": Lh,
        "batch": batch,
        "one_shot": one,
        "overlap_save": osd,
        "bytes_ratio": one_bytes / os_bytes if os_bytes else float("inf"),
    }


def pencil_report(
    n: int,
    d: int,
    batch: int = 1,
    *,
    n1: Optional[int] = None,
    n2: Optional[int] = None,
    pack: bool = True,
    chunks: int = 1,
    natural_order: bool = True,
    hw: HW = H100,
) -> dict:
    """Modelled cost of the distributed pencil FFT over ``d`` ranks, the
    reference's formulas over the port's planner:

    * per-step **comm bytes**: every transpose moves the rank's whole
      slab, ``(d − 1)/d`` of it over the wire;
    * **local HBM bytes**: the n1 column program (at batch·q pencils), the
      twiddle multiply (slab read + write and the rank's window), the n2
      row program (at batch·p pencils) and the natural-order reorder;
    * :data:`COLLECTIVE_LAUNCH_S` per collective call: what packing the
      split-complex pair into one all-to-all halves and strip-mining into
      ``chunks`` pieces pays more of;
    * the pipelined middle: with ``chunks=K`` the two inner transposes
      overlap the column FFT and twiddle chunk by chunk,
      ``cc + fc + (K − 1)·max(cc, fc)`` instead of their sum.

    ``modeled_s`` is the config's total and ``serial_s`` the unpacked K = 1
    schedule of the same factors, so ``overlap_win`` is the speed-up the
    tuner claims.  Seconds divide by ``hw``'s rates (the H100's here, a
    TPU v5e's in the reference); bytes and counts are the reference's.
    """
    from repro_torch.core import plan as plan_lib  # local: analysis stays lazy

    if n1 is None or n2 is None:
        from repro_torch.core import distributed as dist  # lazy: distributed plans through here

        n1, n2 = dist.pencil_factors(n, d)
    if n1 * n2 != n:
        raise ValueError(f"pencil factors {n1}x{n2} != n={n}")
    p, q = n1 // max(d, 1), n2 // max(d, 1)
    f32, planes = 4, 2
    slab = batch * (n // max(d, 1))  # elements per plane per rank
    slab_bytes = slab * planes * f32
    wire_step = slab_bytes * (d - 1) / max(d, 1)  # one transpose, per rank
    a2a_steps = (3 if natural_order else 2) if d > 1 else 0
    K = max(1, chunks) if (pack and d > 1) else 1
    # The two inner transposes are K calls each and the natural-order
    # reorder one packed call; unpacked pays two calls (xr, xi) a step.
    if d <= 1:
        a2a_calls = 0
    elif pack:
        a2a_calls = 2 * K + (1 if natural_order else 0)
    else:
        a2a_calls = 2 * a2a_steps

    fft1_bytes = plan_lib.program_hbm_bytes(plan_lib.plan_fft(n1).passes, batch * q)
    fft2_bytes = plan_lib.program_hbm_bytes(plan_lib.plan_fft(n2).passes, batch * p)
    twiddle_bytes = 2 * slab_bytes + n1 * q * planes * f32  # slab r/w + window
    reorder_bytes = 2 * slab_bytes if (natural_order and d > 1) else 0
    local_bytes = fft1_bytes + twiddle_bytes + fft2_bytes + reorder_bytes

    t_step = wire_step / hw.link_bw
    t_mid_compute = (fft1_bytes + twiddle_bytes) / hw.hbm_bw
    if d > 1:
        cc, fc = 2 * t_step / K, t_mid_compute / K
        t_middle = cc + fc + (K - 1) * max(cc, fc)
    else:
        t_middle = t_mid_compute
    t_tail = fft2_bytes / hw.hbm_bw + reorder_bytes / hw.hbm_bw
    if natural_order and d > 1:
        t_tail += t_step
    modeled = t_middle + t_tail + a2a_calls * COLLECTIVE_LAUNCH_S
    serial = a2a_steps * t_step + local_bytes / hw.hbm_bw + (2 * a2a_steps) * COLLECTIVE_LAUNCH_S
    return {
        "n": n,
        "d": d,
        "batch": batch,
        "n1": n1,
        "n2": n2,
        "pack": pack,
        "chunks": K,
        "natural_order": natural_order,
        "a2a_steps": a2a_steps,
        "a2a_calls": a2a_calls,
        "comm_bytes_per_step": wire_step,
        "comm_bytes_total": wire_step * a2a_steps,
        "fft1_bytes": fft1_bytes,
        "fft2_bytes": fft2_bytes,
        "twiddle_bytes": twiddle_bytes,
        "local_hbm_bytes": local_bytes,
        "comm_s": a2a_steps * t_step,
        "memory_s": local_bytes / hw.hbm_bw,
        "modeled_s": modeled,
        "serial_s": serial,
        "overlap_win": serial / modeled if modeled else float("inf"),
    }


def collective_bytes(cost) -> dict:
    """Per-rank collective payload bytes by kind, from a trace (the
    reference's keys; its HLO walk's loop flag is always 0 here: a Python
    loop runs and is counted)."""
    return {
        "per_device_bytes": float(cost.collective_bytes),
        "by_type": dict(cost.collective_by_type),
        "num_ops": float(cost.collective_ops),
        "unknown_trip_loops": int(cost.unknown_trip_loops),
    }


def model_flops(n_params_active: int, tokens: int) -> float:
    """6·N·D — the useful-FLOPs yardstick (N = active params)."""
    return 6.0 * n_params_active * tokens


def _peak(hw: HW, dtype: str) -> float:
    """The peak a dtype's flops run at: bf16 / fp16 on the tensor cores,
    fp32 (TF32 off, the port's setting) and everything else on the CUDA
    cores."""
    return hw.peak_flops_bf16 if dtype in ("bf16", "bfloat16", "float16", "f16") else hw.peak_flops_f32


def roofline_terms(
    flops_per_chip,
    bytes_per_chip: float,
    coll_bytes_per_chip: float,
    hw: HW = H100,
    dtype: str = "bf16",
) -> dict:
    """The compute, memory and collective terms of one step on one card
    and the bound among them, with the reference's keys.  ``flops_per_chip``
    is a count (all at ``dtype``'s peak, as the reference charges it) or a
    ``{dtype: flops}`` mapping, each part at its own dtype's peak: the
    port's fp32 GEMMs (the spectral mixer's, TF32 off) at 67 TFLOP/s and
    its bf16 ones at 989."""
    if isinstance(flops_per_chip, dict):
        t_c = sum(f / _peak(hw, dt) for dt, f in flops_per_chip.items())
    else:
        t_c = flops_per_chip / _peak(hw, dtype)
    t_m = bytes_per_chip / hw.hbm_bw
    t_x = coll_bytes_per_chip / hw.link_bw
    dom = max(("compute", t_c), ("memory", t_m), ("collective", t_x), key=lambda kv: kv[1])
    return {
        "compute_s": t_c,
        "memory_s": t_m,
        "collective_s": t_x,
        "bound": dom[0],
        "step_lower_bound_s": dom[1],
        # fraction of roofline the *dominant* resource achieves if the other
        # two overlap perfectly; the perf loop drives the dominant term down.
        "balance": {
            "compute": t_c / dom[1] if dom[1] else 0.0,
            "memory": t_m / dom[1] if dom[1] else 0.0,
            "collective": t_x / dom[1] if dom[1] else 0.0,
        },
    }


def summarize_cell(record: dict, hw: HW = H100) -> str:
    r = record
    t = r["roofline"]
    return (
        f"{r['arch']:18s} {r['shape']:12s} {r['mesh']:9s} "
        f"C={t['compute_s']*1e3:9.2f}ms M={t['memory_s']*1e3:9.2f}ms "
        f"X={t['collective_s']*1e3:9.2f}ms bound={t['bound']:10s} "
        f"useful={r.get('useful_flops_frac', 0):5.1%}"
    )
