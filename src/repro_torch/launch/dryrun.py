"""Multi-pod dry run: trace every (arch × shape × mesh) cell on fake tensors.

Counterpart of ``src/repro/launch/dryrun.py``.  The reference fakes 512
host devices, lowers each cell's sharded train / prefill / decode function
against ``ShapeDtypeStruct``s and compiles it.  The port has no compiler
between its Python and the card, so it runs each cell's real step once, in
one process, as rank 0 of a fake process group of the mesh's size
(``torch.distributed``'s ``fake`` backend: every collective returns at
once) on ``FakeTensor``s (:mod:`repro_torch.core.fake`): the parameters are
built on the meta device, made fake and sharded by
:func:`repro_torch.sharding.shard.shard_model`, the inputs come from
:mod:`repro_torch.configs.specs`, and :func:`repro_torch.analysis.trace.analyze`
counts what the step does on one card:

  * the live-bytes peak    → per-card bytes (does the cell fit 80 GB?)
  * flops and bytes moved  → the roofline's compute and memory terms
  * collectives by kind    → the roofline's collective term
  * kernel launches        → by name, each one's bytes and flops

A train step traces one microbatch's forward and backward, scaled by
``microbatches``, and one optimizer step.  The multi-pod mesh (2, 16, 16)
runs as the 2-D mesh (32, 16) over ('data', 'model'): every rule that names
``data`` names ``pod`` with it (the batch, FSDP's embed dim), so folding the
pod axis into ``data`` shards every parameter and batch as the reference's
rules do.  The reference's ``DECODE_CACHE_MODE`` does not apply: the port
has one cache form, written in place.  A decode cell runs as the
reference's ``_lower_decode``: weight-stationary where the model is FSDP
(``par_act``: the weights keep their training shards, the batch is
replicated over ``data``), against the caches ``cache_shardings`` gives
(``long_500k``'s one sequence: its slots split where the kv heads do not
divide ``model``).  A decode record's ``per_chip`` adds
``collectives_by_axis`` (kind:axis → count, from
:data:`repro_torch.sharding.shard.BY_AXIS`).  Any error is a failure.

Artifacts land in ``artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json``
with the reference's record keys (``trace_s`` for its ``compile_s``; its
XLA-only fields left out; ``launches`` added).  No card is needed::

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch h2o-danube-1.8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--both-meshes]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
import warnings

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.analysis import roofline as rl
from repro_torch.analysis.trace import TraceCost, trace
from repro_torch.configs import specs as specs_lib
from repro_torch.configs.base import LM_SHAPES, TrainConfig, get_config, list_archs, shapes_for
from repro_torch.core import fake
from repro_torch.launch import shardings as sh_lib
from repro_torch.launch.mesh import make_mesh, parallel_config_for

__all__ = ["ART_DIR", "FSDP_THRESHOLD", "train_cfg_for", "fake_group", "trace_cell", "active_params",
           "run_cell", "all_cells", "main"]

ART_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "artifacts", "dryrun_torch")

FSDP_THRESHOLD = 2_000_000_000  # params; above this shard params over data too

MESHES = {"16x16": (16, 16), "2x16x16": (2, 16, 16)}


def train_cfg_for(arch: str) -> TrainConfig:
    # adafactor for the 480B MoE (Adam moments would not fit); adamw elsewhere.
    # microbatches=8: global batch 256 → 2 sequences per chip per microbatch.
    opt = "adafactor" if arch == "arctic-480b" else "adamw"
    mb = 16 if arch in ("arctic-480b", "qwen2-vl-72b") else 8
    return TrainConfig(optimizer=opt, microbatches=mb)


@contextlib.contextmanager
def fake_group(world: int):
    """This process as rank 0 of a fake process group of ``world`` ranks
    for the duration (a group of that size and backend already in place is
    reused).  Raises naming the module when torch lacks the fake backend:
    the dry run never falls back to a real group."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:  # pragma: no cover - depends on the torch build
        raise RuntimeError("the dry run needs torch's fake process group "
                           "(torch.testing._internal.distributed.fake_pg)") from e
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == world:
            yield
            return
        raise RuntimeError(f"a {dist.get_backend()} process group of {dist.get_world_size()} ranks is in place; "
                           f"the dry run needs a fake one of {world}")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mesh(mesh_shape: tuple):
    """The 2-D (data, model) mesh of ``mesh_shape`` over the fake group
    (a leading pod axis folded into data)."""
    shape = (math.prod(mesh_shape[:-1]), mesh_shape[-1])
    return make_mesh(shape, ("data", "model"), device=fake.card().type)


def _fake(t: torch.Tensor) -> torch.Tensor:
    """A fake tensor of ``t``'s shape and dtype on the simulated card."""
    return torch.empty(t.shape, dtype=t.dtype, device=fake.card())


def _fake_model(cfg, mesh, par):
    """``cfg``'s model with fake parameters, sharded over ``mesh`` (built
    on the meta device: nothing is drawn or allocated)."""
    from repro_torch.models.model import DecoderLM
    from repro_torch.sharding import shard

    model = DecoderLM(cfg, device="meta")
    for mod in model.modules():
        for k, p in list(mod._parameters.items()):
            if p is not None:
                mod._parameters[k] = nn.Parameter(_fake(p), requires_grad=p.requires_grad)
    return shard.shard_model(model, mesh, par)


def _fit_microbatches(train_cfg, batch: int, data: int):
    """``train_cfg`` with the most microbatches, up to its own, whose rows
    split evenly over ``data`` shards: the port's step gives every data
    shard its rows of each microbatch, where the reference's rules may
    shard a small microbatch over the pod axis alone (2×16×16: 16 rows of
    arctic-480b's 16 microbatches over 32 data shards run as 8 of 32)."""
    mb = max(1, train_cfg.microbatches)
    while mb > 1 and batch % (mb * data):
        mb -= 1
    return dataclasses.replace(train_cfg, microbatches=mb)


def _trace_train(cfg, shape, mesh, par, train_cfg):
    """One microbatch's forward and backward (this rank's rows) scaled by
    ``microbatches``, plus the step that ends it (the sums' zeros, the
    mean, clipping and the optimizer)."""
    from repro_torch.train import compression as comp_lib
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.train_loop import TrainState, make_train_step

    model = _fake_model(cfg, mesh, par)
    opt_init, _ = make_optimizer(train_cfg)
    err = comp_lib.init_error_state(model) if train_cfg.grad_compression else {}
    state = TrainState(step=0, model=model, opt_state=opt_init(model), err_state=err)
    batch = {k: _fake(v) for k, v in specs_lib.input_specs(cfg, shape).items()}
    step = make_train_step(cfg, train_cfg)
    if train_cfg.microbatches <= 1:
        return trace(step, state, batch)[1]
    part = step.micro(model, batch)[0]
    acc = step.begin(model)
    metrics, cost = trace(step.accumulate, model, part, acc, _live=(state,))
    cost = cost.scaled(train_cfg.microbatches)
    del acc
    cost.add(trace(lambda: step.finish(state, step.begin(model), metrics), _live=(state,))[1])
    return cost


def _trace_prefill(cfg, shape, mesh, par):
    """The prefill of this rank's rows."""
    from repro_torch.sharding import shard

    model = _fake_model(cfg, mesh, par)
    batch = {k: shard.data_rows(model, _fake(v)) for k, v in specs_lib.input_specs(cfg, shape).items()}
    tokens = batch.pop("tokens", None)
    return trace(model.prefill, tokens, _live=(model,), **batch)[1]


def _trace_decode(cfg, shape, mesh, par):
    """One decode step against this rank's shards of caches of ``seq_len``
    positions, writing the last slot, as the reference lowers it
    (``par_act``: weight-stationary for an FSDP model); with spectral layers
    also the step that flushes their streams, once every C tokens (their
    caches at phase C − 1).  Returns (the step's cost, the flush step's or
    None, C, the step's collectives by kind and axis)."""
    from repro_torch.models.layers.spectral import SpectralStreamCache
    from repro_torch.sharding import shard

    par_act = dataclasses.replace(par, decode_weight_stationary=par.fsdp)
    model = _fake_model(cfg, mesh, par_act)
    # The previous tokens (decode_state_specs' (B,) ids: this rank's rows,
    # or all of them where replicated) and this rank's shards of the
    # global batch's caches (KV in the compute dtype or int8).
    tokens = shard.data_rows(model, torch.empty(shape.global_batch, dtype=torch.long, device=fake.card()),
                             decode=True)
    caches = model.cache_init(shape.global_batch, shape.seq_len)
    t = shape.seq_len - 1
    shard.reset_counts()
    step = trace(model.decode_step, tokens, caches, t, _live=(model,))[1]
    by_axis = dict(shard.BY_AXIS)
    streams = [c.chunk.shape[-1] for c in caches if isinstance(c, SpectralStreamCache)]
    if not streams:
        return step, None, 0, by_axis
    c = streams[0]
    flushing = [x._replace(phase=c - 1) if isinstance(x, SpectralStreamCache) else x for x in caches]
    return step, trace(model.decode_step, tokens, flushing, t, _live=(model,))[1], c, by_axis


# ---------------------------------------------------------------------------
# fftbench cells: the distributed FFT (the paper's own workload)
# ---------------------------------------------------------------------------


def _fft_plan_info(fft_shape, model_n: int) -> dict:
    """Plan metadata recorded beside the trace, the reference's keys but
    ``gpu_reports`` (its ``pallas_gpu`` backend is not ported): the pencil
    schedule the card runs (modelled only, so every rank derives it), each
    leaf's schedule and modelled HBM bytes per pass, the Bluestein and
    convolution reports."""
    from repro_torch.core import distributed as dist_lib
    from repro_torch.core import plan as plan_lib

    def _bluestein_reports(lengths, batch: int) -> list:
        return [rl.bluestein_report(m, batch=batch) for m in lengths if m & (m - 1)]

    if fft_shape.kind == "fft2d":
        # (batch, n1, n2) images: last axis n2 rows-first, columns n1.
        n_row, n_col = fft_shape.n2, fft_shape.n
        info = {
            "leaf_lengths": [n_col, n_row],
            "joint_schedule": plan_lib.describe(n_row, n2=n_col),
            "hbm_round_trips": plan_lib.plan_fft2(n_row, n_col).hbm_round_trips,
            "pass_programs": [rl.fft_pass_report(n_row, batch=fft_shape.batch, n2=n_col)],
        }
        blu = _bluestein_reports([n_row], fft_shape.batch * n_col)
        if blu:
            info["bluestein_reports"] = blu
        return info
    ppl = dist_lib.plan_pencil(fft_shape.n, model_n)
    leaf_ns = [ppl.n1, ppl.n2]
    total = fft_shape.n
    info = {
        "leaf_lengths": leaf_ns,
        "leaf_schedules": [plan_lib.describe(m) for m in leaf_ns],
        "pencil_schedule": ppl.describe(),
        "a2a_count": ppl.a2a_count(fft_shape.kind != "fftconv"),
        "comm_report": {k: ppl.report[k] for k in ("comm_bytes_per_step", "local_hbm_bytes", "modeled_s")},
        "hbm_round_trips": max(plan_lib.plan_fft(m).hbm_round_trips for m in leaf_ns),
        # A length-m leaf runs over batch × (total/m) pencils.
        "pass_programs": [rl.fft_pass_report(m, batch=fft_shape.batch * (total // m)) for m in leaf_ns],
    }
    if fft_shape.kind == "fftconv":
        info["conv_report"] = rl.conv_report(fft_shape.n, 4097, batch=fft_shape.batch)
    blu = _bluestein_reports(leaf_ns, fft_shape.batch * (total // max(leaf_ns)))
    if blu:
        info["bluestein_reports"] = blu
    return info


def _trace_fft(fft_shape, mesh):
    """This rank's shard of the distributed transform: rows over ``data``,
    the transform axis over ``model``; the convolution's forward in pencil
    layout, the spectrum multiply and the inverse from it (4 all-to-alls,
    not 6)."""
    from repro_torch.core import distributed as dist_lib
    from repro_torch.core.fft_torch import cmul

    d, m = mesh.size(0), mesh.size(1)
    group = mesh.get_group(1)
    rows = fft_shape.batch // d if fft_shape.batch % d == 0 else fft_shape.batch
    dev = fake.card()
    if fft_shape.kind == "fft2d":
        n1, n2 = fft_shape.n, fft_shape.n2
        x = [torch.empty(rows, n1 // m, n2, device=dev) for _ in range(2)]
        return trace(lambda xr, xi: dist_lib.pfft2d(xr, xi, n1=n1, n2=n2, group=group), *x)[1]
    n = fft_shape.n
    x = [torch.empty(rows, n // m, device=dev) for _ in range(2)]
    if fft_shape.kind == "fft1d":
        return trace(lambda xr, xi: dist_lib.pfft(xr, xi, n=n, group=group), *x)[1]
    h = [torch.empty(n // m, device=dev) for _ in range(2)]

    def conv(xr, xi, hr, hi):
        yr, yi = dist_lib.pfft(xr, xi, n=n, group=group, natural_order=False)
        return dist_lib.pifft(*cmul(yr, yi, hr, hi), n=n, group=group, from_pencil=True)

    return trace(conv, *x, *h)[1]


# ---------------------------------------------------------------------------


def active_params(cfg) -> int:
    """Active params per token (MoE: top-k + shared experts only)."""
    total = sh_lib.param_count(cfg)
    if cfg.num_experts and cfg.top_k:
        values, _ = sh_lib.abstract_params(cfg)
        expert = 0
        for name, leaf in values.items():
            is_expert = cfg.num_experts in leaf.shape[:2] and leaf.ndim in (3, 4)
            if "moe" in name and any(k in name for k in ("wi_gate", "wi_up", "wo")) and is_expert:
                expert += leaf.numel()
        return total - expert + expert * cfg.top_k // cfg.num_experts
    return total


def _mesh_tag(mesh_shape: tuple) -> str:
    return "x".join(map(str, mesh_shape))


def trace_cell(cfg, shape, mesh_shape: tuple, train_cfg=None, fsdp=None) -> dict:
    """The record of one cell: ``cfg`` at ``shape`` (a ``ShapeConfig``, or
    an ``FFTShape`` of fftbench) on a mesh of ``mesh_shape`` ((data,
    model), or (pod, data, model)), traced as rank 0 of a fake group of
    that many ranks; ``train_cfg`` (a train shape's; default
    :func:`train_cfg_for`); ``fsdp`` (default: above
    :data:`FSDP_THRESHOLD` parameters).  A decode cell of a model with
    spectral layers also records ``flush_step`` (the step that flushes
    their streams) and ``decode_cycle`` (the mean step over the C steps of
    a flush's cycle; its peak the flush's), each with ``per_chip``,
    ``launches``, ``fits_hbm`` and ``roofline``; its ``fits_hbm`` holds
    for both steps.  Errors are recorded, not raised."""
    world = math.prod(mesh_shape)
    record = {"arch": cfg.name, "shape": shape.name, "mesh": _mesh_tag(mesh_shape), "status": "error"}
    flush = None
    t0 = time.time()
    try:
        from torch._subclasses.fake_tensor import FakeTensorMode

        with fake_group(world):
            mesh = _mesh(mesh_shape)
            with FakeTensorMode():
                if cfg.family == "fft":
                    cost = _trace_fft(shape, mesh)
                    record["fft_plan"] = _fft_plan_info(shape, mesh.size(1))
                    tokens, n_active = 0, 0
                else:
                    if fsdp is None:
                        fsdp = sh_lib.param_count(cfg) > FSDP_THRESHOLD
                    par = parallel_config_for(mesh, fsdp=fsdp, sequence_parallel=True)
                    if shape.kind == "train":
                        tc = _fit_microbatches(train_cfg or train_cfg_for(cfg.name), shape.global_batch,
                                               mesh.size(0))
                        record["train"] = {"optimizer": tc.optimizer, "microbatches": tc.microbatches}
                        cost = _trace_train(cfg, shape, mesh, par, tc)
                        tokens = shape.global_batch * shape.seq_len
                    elif shape.kind == "prefill":
                        cost = _trace_prefill(cfg, shape, mesh, par)
                        tokens = shape.global_batch * shape.seq_len
                    else:
                        cost, flush, chunk, by_axis = _trace_decode(cfg, shape, mesh, par)
                        tokens = shape.global_batch  # one new token per sequence
                        if "spectral" in cfg.pattern():
                            from repro_torch.models.layers import spectral as spec_lib

                            record["spectral_stream"] = spec_lib.stream_plan_info(cfg, batch=shape.global_batch)
                    n_active = active_params(cfg)
        record.update(_summary(cfg, shape, cost, world, tokens, n_active, time.time() - t0))
        if shape.kind == "decode":
            record["per_chip"]["collectives_by_axis"] = by_axis
        if flush is not None:
            # The flush step, and the mean step over the C-step cycle
            # (C − 1 steps as traced, one flush).
            cycle = cost.scaled((chunk - 1) / chunk)
            cycle.add(flush.scaled(1 / chunk))
            for key, c in (("flush_step", flush), ("decode_cycle", cycle)):
                part = _summary(cfg, shape, c, world, tokens, n_active, 0.0)
                record[key] = {k: part[k] for k in ("per_chip", "launches", "fits_hbm", "roofline")}
            record["decode_cycle"]["chunk"] = chunk
            record["fits_hbm"] = record["fits_hbm"] and record["flush_step"]["fits_hbm"]
    except Exception as e:  # noqa: BLE001 — record and continue the sweep
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-2000:]
    return record


def _summary(cfg, shape, cost: TraceCost, chips: int, tokens: int, n_active: int, trace_s: float) -> dict:
    coll = rl.collective_bytes(cost)
    flops = float(cost.flops)
    useful = 0.0
    if cfg.family != "fft":
        per_tok = 6 if shape.kind == "train" else 2
        useful = float(per_tok) * n_active * tokens
    return dict(
        status="ok",
        trace_s=round(trace_s, 1),
        chips=int(chips),
        per_chip=dict(
            flops=flops,
            dot_flops=float(cost.dot_flops),
            dot_flops_by_dtype=dict(cost.dot_flops_by_dtype),
            dot_flops_by_op=dict(cost.dot_flops_by_op),
            hbm_bytes=float(cost.bytes),
            collective_bytes=coll["per_device_bytes"],
            collective_by_type=coll["by_type"],
            collective_ops=coll["num_ops"],
            collective_count_by_type=dict(cost.collective_count_by_type),
            unknown_trip_loops=coll["unknown_trip_loops"],
            kernel_bytes=float(cost.kernel_bytes),
            kernel_flops=float(cost.kernel_flops),
            eager_ops=float(cost.ops),
            peak_memory_bytes=int(cost.peak_memory_bytes),
            argument_bytes=int(cost.argument_bytes),
        ),
        launches={k: float(v) for k, v in sorted(cost.launches.items())},
        fits_hbm=bool(cost.peak_memory_bytes < rl.H100.hbm_bytes),
        roofline=rl.roofline_terms(cost.flops_by_dtype(), float(cost.bytes), coll["per_device_bytes"]),
        useful_flops=useful,
        useful_flops_frac=(useful / chips) / flops if flops else 0.0,
        active_params=n_active,
        tokens_per_step=tokens,
    )


def run_cell(arch: str, shape_name: str, multi_pod: bool, force: bool = False) -> dict:
    mesh_tag = "2x16x16" if multi_pod else "16x16"
    os.makedirs(ART_DIR, exist_ok=True)
    out_path = os.path.join(ART_DIR, f"{arch}__{shape_name}__{mesh_tag}.json")
    if os.path.exists(out_path) and not force:
        with open(out_path) as f:
            return json.load(f)
    cfg = get_config(arch)
    if cfg.family == "fft":
        from repro_torch.configs import fftbench as fb

        shape = next(s for s in fb.FFT_SHAPES if s.name == shape_name)
    else:
        shape = LM_SHAPES[shape_name]
    record = trace_cell(cfg, shape, MESHES[mesh_tag])
    with open(out_path, "w") as f:
        json.dump(record, f, indent=1)
    return record


def all_cells(include_fft=True):
    cells = []
    for arch in list_archs():
        cfg = get_config(arch)
        if cfg.family == "fft":
            if include_fft:
                from repro_torch.configs import fftbench as fb

                cells += [(arch, s.name) for s in fb.FFT_SHAPES]
            continue
        cells += [(arch, s.name) for s in shapes_for(arch)]
    return cells


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true", help="2x16x16 mesh")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--no-fft", action="store_true")
    args = ap.parse_args(argv)
    # torch's notice that all_gather_into_tensor has a newer name, once per
    # cell: the port's collectives are counted, not changed, here.
    warnings.filterwarnings("ignore", message=".*all_gather_into_tensor.*", category=FutureWarning)

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    if args.all:
        cells = all_cells(include_fft=not args.no_fft)
    else:
        assert args.arch and args.shape, "--arch and --shape or --all"
        cells = [(args.arch, args.shape)]

    failures = 0
    for arch, shape_name in cells:
        for mp in meshes:
            rec = run_cell(arch, shape_name, mp, force=args.force)
            if rec["status"] == "ok":
                t = rec["roofline"]
                print(
                    f"OK   {arch:18s} {shape_name:12s} {rec['mesh']:8s} "
                    f"trace={rec['trace_s']:6.1f}s "
                    f"C={t['compute_s']*1e3:8.2f}ms M={t['memory_s']*1e3:8.2f}ms "
                    f"X={t['collective_s']*1e3:8.2f}ms bound={t['bound']:10s} "
                    f"mem={rec['per_chip']['peak_memory_bytes']/1e9:5.2f}GB "
                    f"fits={rec['fits_hbm']}",
                    flush=True,
                )
            else:
                failures += 1
                print(f"FAIL {arch:18s} {shape_name:12s} mp={mp}: {rec['error']}", flush=True)
    print(f"done; failures={failures}")
    return failures


if __name__ == "__main__":
    raise SystemExit(main())
