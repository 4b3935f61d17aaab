"""Training launcher: mesh setup, sharded state, checkpoint/restart loop.

Port of ``repro/launch/train.py``, with the reference's flags and
``--device`` (the card by default; ``cpu`` for the plain route)::

  PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \\
      --reduced --steps 3 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \\
      --spectral --batch 2 --seq 4096 --steps 8 --ckpt-dir build/run1
  torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch h2o-danube-1.8b \
      --reduced --steps 3 --mesh 2x2 --device cpu

Fault-tolerance behaviour exercised here:
  * auto-resume from the newest complete checkpoint (the model, the
    optimizer and error-feedback state and the data step);
  * async checkpointing every --ckpt-every steps, keep-N garbage collection;
  * a step watchdog that aborts on hangs (crash-only restart);
  * straggler stats (EWMA step times) reported at the end.

``--mesh DATAxMODEL`` other than ``1x1`` trains the sharded model
(:mod:`repro_torch.sharding`) over a ``DeviceMesh`` of that shape, with
the reference's ``parallel_config_for`` (no FSDP): over the process group
the caller set up, or else one initialised from ``torchrun``'s environment
(NCCL on the card, gloo for ``--device cpu``); a world size other than
DATA·MODEL raises ``ValueError``.  Every rank makes the same batches and
takes its rows; rank 0 prints, and the checkpoints are topology-free (a
restore re-shards onto the current mesh).  ``--mesh 1x1`` is the
one-device loop.  The reference's XLA overlap flags have no counterpart.  The synthetic pipeline makes token
batches, so an audio config (musicgen-large, which takes frame embeddings)
is refused with a ``ValueError``; a vision config trains on its tokens.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import TrainConfig, get_config
from repro_torch.configs.reduce import make_reduced
from repro_torch.core import fft as fft_lib
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch.mesh import make_mesh, parallel_config_for
from repro_torch.runtime.fault_tolerance import StepWatchdog, StragglerStats, with_retries
from repro_torch.train.train_loop import init_train_state, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true", help="smoke-scale config")
    ap.add_argument("--spectral", action="store_true",
                    help="the paper-integration flag use_spectral_mixer: (spectral, attn) layer pairs")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--stop-at", type=int, default=None,
                    help="stop (simulate a crash) after this step; the schedule still spans --steps")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--mesh", default="1x1", help="DATAxMODEL, e.g. 2x2")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--watchdog-timeout", type=float, default=600.0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cpu for the plain route; the card by default (raises without one)")
    args = ap.parse_args(argv)

    dshape = tuple(int(x) for x in args.mesh.split("x"))
    cfg = get_config(args.arch)
    if cfg.frontend == "audio":
        raise ValueError(f"{cfg.name}: the training pipeline makes token batches, and an audio model "
                         "takes frame embeddings (loss_fn's frame_embeds)")
    if args.spectral:
        cfg = dataclasses.replace(cfg, use_spectral_mixer=True)
    if args.reduced:
        cfg = make_reduced(cfg)

    tc = TrainConfig(
        optimizer=args.optimizer,
        learning_rate=args.lr,
        total_steps=args.steps,
        warmup_steps=max(1, args.steps // 20),
        batch_size=args.batch,
        seq_len=args.seq,
        microbatches=args.microbatches,
        grad_compression=args.grad_compression,
    )
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch)

    # ---- state: init or resume ----------------------------------------
    dev = fft_lib._resolve_device(args.device)
    mesh = par = None
    owned = False  # a process group this launcher initialised, destroyed at the end
    if dshape != (1, 1):
        owned = not dist.is_initialized()
        mesh, dev = _mesh(dshape, dev)
        par = parallel_config_for(mesh)
    lead = mesh is None or dist.get_rank() == 0
    state = init_train_state(cfg, tc, device=dev, generator=torch.Generator(device=dev).manual_seed(tc.seed),
                             mesh=mesh, par=par)
    mgr = CheckpointManager(args.ckpt_dir, keep=tc.keep_checkpoints) if args.ckpt_dir else None
    start_step = 0
    if mgr is not None:
        latest = mgr.latest_step()
        if latest is not None:
            state, extra = mgr.restore(latest, state)
            start_step = int(extra.get("data_step", latest))
            if lead:
                print(f"[resume] restored step {latest} onto {state.model.device}"
                      + (f" (mesh {args.mesh})" if mesh is not None else ""))

    data = SyntheticLM(dcfg, start_step=start_step)
    step_fn = make_train_step(cfg, tc)

    # ---- loop with watchdog / straggler tracking ------------------------
    def on_hang():
        print("[watchdog] step exceeded timeout — aborting for supervisor restart", flush=True)
        os._exit(17)

    watchdog = StepWatchdog(args.watchdog_timeout, on_hang)
    stats = StragglerStats()
    losses = []
    stop = min(args.steps, args.stop_at) if args.stop_at else args.steps
    try:
        for i in range(start_step, stop):
            batch = data.batch_at(i)
            watchdog.arm()
            t0 = time.time()
            state, metrics = with_retries(lambda: step_fn(state, batch))
            losses.append(float(metrics["loss"]))  # reads the device: the step is done
            dt = time.time() - t0
            watchdog.disarm()
            slow = stats.record(dt)
            if lead and (i % args.log_every == 0 or i == args.steps - 1):
                print(
                    f"step {i:5d} loss={losses[-1]:.4f} ce={float(metrics['ce']):.4f} "
                    f"gnorm={float(metrics['grad_norm']):.3f} lr={metrics['lr']:.2e} "
                    f"dt={dt * 1e3:.0f}ms{' [straggler]' if slow else ''}",
                    flush=True,
                )
            if mgr is not None and (i + 1) % args.ckpt_every == 0:
                mgr.save(i + 1, state, extra={"data_step": i + 1}, blocking=False)
        if mgr is not None:
            mgr.save(stop, state, extra={"data_step": stop}, blocking=True)
            mgr.wait()
    finally:
        watchdog.close()
        if owned:
            dist.destroy_process_group()
    if losses and lead:
        print("final:", {"loss_first": losses[0], "loss_last": losses[-1], **stats.summary()}, flush=True)
    return losses


def _mesh(dshape: tuple, dev: torch.device):
    """The (data, model) ``DeviceMesh`` of ``dshape`` over the caller's
    process group, or one from ``torchrun``'s environment, and this rank's
    device."""
    mesh, need = "x".join(map(str, dshape)), dshape[0] * dshape[1]
    if not dist.is_initialized():
        if not {"RANK", "WORLD_SIZE"} <= set(os.environ):
            raise ValueError(f"--mesh {mesh} needs {need} ranks; there is no process group and no "
                             "torchrun environment (RANK, WORLD_SIZE)")
        dist.init_process_group("gloo" if dev.type == "cpu" else "nccl")
    world = dist.get_world_size()
    if world != need:
        raise ValueError(f"--mesh {mesh} needs {need} ranks; the process group has {world}")
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)) % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return make_mesh(dshape, ("data", "model"), device=dev.type), dev


if __name__ == "__main__":
    main()
