"""phi4-mini-3.8b: 32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064.

RoPE + SwiGLU + GQA.  [arXiv:2412.08905; hf]
long_500k: SKIPPED — pure full attention.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=200064,
    rope_theta=10000.0,
)

SHAPES = ["train_4k", "prefill_32k", "decode_32k"]
