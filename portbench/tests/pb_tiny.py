"""Shared by the benchmark's CPU tests: the import path and each cell at a
size a test run holds (the plain CPU route of the port)."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

SAR = {"config": {"n_az": 64, "n_rg": 128, "chirp_len": 16, "scenes": 4},
       "traffic": {"ahead": 2, "check_sample": 4, "trace_slice": [0.2, 0.3]}}
SPOTLIGHT = {"n_az": 32, "n_rg": 64, "scenes": 3, "noise": 0.05, "spotlight_targets": [[64, 700], [200, 2048], [400, 3500]],
             "spotlight_targets_at": [512, 4096]}
BATCHED = {"n": 4096, "batch": 3}
LM = {"config": {"hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 4, "num_attention_heads": 4,
                 "num_key_value_heads": 2, "vocab_size": 256, "spectral_filter_len": 16, "attn_chunk": 16,
                 "attn_chunk_threshold": 32},
      "traffic": {"prompt_min": 8, "prompt_max": 64, "distinct": 6, "rate_per_s": 20.0, "check_sample": 3,
                  "trace_slice": [0.2, 0.3]}}
TINY = {"sar_stripmap": SAR, "danube_prefill": LM}
