"""Batched serving example: prefill once, decode with KV caches + sampling.

The PyTorch/CUDA counterpart of ``examples/serve_decode.py``: the reduced
h2o-danube-1.8b (weights from seed 0) served at the bf16 and the int8
quantized KV cache, on the card unless ``--device cpu``.

  PYTHONPATH=src python examples/serve_decode_torch.py
  PYTHONPATH=src python examples/serve_decode_torch.py --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs.base import get_config
from repro_torch.configs.reduce import make_reduced
from repro_torch.core import fft as F
from repro_torch.models.model import DecoderLM
from repro_torch.serving.engine import Engine, ServeConfig


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cpu for the plain route; the card by default")
    args = ap.parse_args(argv)
    dev = F._resolve_device(args.device)

    cfg = make_reduced(get_config("h2o-danube-1.8b"))
    prompts = torch.randint(4, cfg.vocab_size, (4, 32), generator=torch.Generator(device=dev).manual_seed(1),
                            device=dev)
    outs = {}
    for kv_dtype in ("bf16", "int8"):
        c = dataclasses.replace(cfg, kv_cache_dtype=kv_dtype)
        with torch.no_grad():
            model = DecoderLM(c, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
            eng = Engine(model, ServeConfig(max_new=24, temperature=0.8, top_k=40))
            t0 = time.time()
            out = eng.generate(prompts)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        print(f"kv_cache={kv_dtype}: generated {tuple(out.shape)} in {time.time() - t0:.1f}s; "
              f"first row: {out[0, :10].tolist()}")
        outs[kv_dtype] = out
    return outs


if __name__ == "__main__":
    main()
