"""End-to-end training script: train a ~100M-class LM for a few hundred steps.

The PyTorch/CUDA counterpart of ``examples/train_lm.py``, with its options,
over :func:`repro_torch.launch.train.main`: the reduced xlstm-125m by
default (``--full`` for the 125M model), synthetic data, AdamW with a
cosine schedule, microbatch gradient accumulation, checkpoints and
crash-safe resume (from the newest checkpoint in ``--ckpt-dir``, so a
second run needs a fresh directory).  On the card unless ``--device cpu``; ``--batch`` and
``--seq`` (8 and 256, the reference's) size a quick run.

  PYTHONPATH=src python examples/train_lm_torch.py
  PYTHONPATH=src python examples/train_lm_torch.py --steps 300 --arch h2o-danube-1.8b
  PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 3 \\
      --arch h2o-danube-1.8b --batch 2 --seq 64
"""

from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.launch.train import main as train_main


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--full", action="store_true", help="full-size config")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--device", default=None, help="cpu for the plain route; the card by default")
    args = ap.parse_args(argv)

    argv = [
        "--arch", args.arch,
        "--steps", str(args.steps),
        "--batch", str(args.batch),
        "--seq", str(args.seq),
        "--microbatches", "2",
        "--ckpt-dir", args.ckpt_dir,
        "--ckpt-every", "50",
        "--log-every", "20",
    ]
    if not args.full:
        argv.append("--reduced")
    if args.device is not None:
        argv += ["--device", args.device]
    losses = train_main(argv)
    if not losses:  # resumed at --steps: the directory holds a finished run
        raise SystemExit(f"{args.ckpt_dir} already holds step {args.steps}: nothing trained; "
                         "give a fresh --ckpt-dir")
    print(f"trained {args.steps} steps: loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    assert losses[-1] < losses[0], "loss did not decrease"
    return losses


if __name__ == "__main__":
    main()
