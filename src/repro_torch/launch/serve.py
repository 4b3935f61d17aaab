"""Serving launcher: phase-timed batched decode sweeps.

Port of ``repro/launch/serve.py`` over
:func:`repro_torch.serving.spectral_serve.sweep_once`.  The model's weights
are drawn from seed 0 (as the reference's ``PRNGKey(0)``) on the card, or on
the plain CPU route with ``--device cpu``; ``--spectral`` sets the
paper-integration flag ``use_spectral_mixer``:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-1.8b \\
      --reduced --spectral --batch 2 --prompt-len 16 --max-new 6 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-1.8b \\
      --spectral --batch 4 --prompt-len 512,4096 --max-new 64 --phase-times
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-125m \\
      --reduced --batch 2 --prompt-len 8,16 --max-new 6 --device cpu

The recurrent configs (zamba2-2.7b, xlstm-125m) take a prompt of at most
one chunk (``cfg.chunk_size``) or of whole chunks, as the reference's.
Prompts are token ids: qwen2-vl-72b is served as text (standard RoPE, its
int8 KV cache), and an audio config (musicgen-large) is refused with a
``ValueError`` before any model is built.
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.configs.base import get_config
from repro_torch.configs.reduce import make_reduced
from repro_torch.core import faults
from repro_torch.core import fft as fft_lib
from repro_torch.models.model import DecoderLM
from repro_torch.serving.engine import Engine, ServeConfig, require_token_prompts
from repro_torch.serving.spectral_serve import sweep_once


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument(
        "--spectral",
        action="store_true",
        help="the paper-integration flag use_spectral_mixer: (spectral, attn) or (spectral, moe) layer pairs",
    )
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument(
        "--prompt-len",
        default="32",
        help="prompt length, or a comma-separated sweep (e.g. 32,128,512)",
    )
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument(
        "--device",
        default=None,
        help="cpu for the plain route; the card by default (raises without one)",
    )
    ap.add_argument(
        "--phase-times",
        action="store_true",
        help="print per-phase seconds (prefill / insert / generate) per row",
    )
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    require_token_prompts(cfg)
    if args.spectral:
        cfg = dataclasses.replace(cfg, use_spectral_mixer=True)
    if args.reduced:
        cfg = make_reduced(cfg)
    device = fft_lib._resolve_device(args.device)  # the card unless --device says otherwise
    with torch.no_grad():
        model = DecoderLM(cfg, device=device, generator=torch.Generator(device=device).manual_seed(0))
    engine = Engine(
        model,
        ServeConfig(
            max_new=args.max_new,
            temperature=args.temperature,
            top_k=args.top_k,
            top_p=args.top_p,
            seed=args.seed,
        ),
    )

    rows = []
    for plen in (int(p) for p in str(args.prompt_len).split(",")):
        r = sweep_once(
            engine,
            batch=args.batch,
            prompt_len=plen,
            max_new=args.max_new,
            warmup=args.warmup,
            seed=args.seed,
        )
        rows.append(r)
        line = (
            f"batch={r['batch']} prompt={r['prompt_len']} max_new={r['max_new']} "
            f"decode={r['decode_tok_per_s']} tok/s e2e={r['e2e_tok_per_s']} tok/s"
        )
        if args.phase_times:
            line += (
                f"  [prefill {r['prefill_s']:.4f}s ({r['prefill_s_per_req']:.4f}/req)"
                f" insert {r['insert_s']:.4f}s generate {r['generate_s']:.4f}s]"
            )
        print(line)
    fired = faults.fault_counters()
    if fired:
        # Chaos-drill visibility: injected sites that fired (REPRO_FAULTS).
        print("faults: " + " ".join(f"{site}x{n}" for site, n in sorted(fired.items())))
    print(f"device: {model.device}" + (f" ({torch.cuda.get_device_name(model.device)})"
                                         if model.device.type == "cuda" else ""))
    return rows


if __name__ == "__main__":
    main()
