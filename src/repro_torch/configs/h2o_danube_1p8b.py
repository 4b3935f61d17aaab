"""h2o-danube-1.8b: 24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000.

llama+mistral mix with sliding-window attention (mistral-style, 4096).
[arXiv:2401.16818; hf]  long_500k: RUN — SWA bounds the KV cache, decode is
sub-quadratic (O(window) per token).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    num_layers=24,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6912,
    vocab_size=32000,
    sliding_window=4096,
    rope_theta=10000.0,
)

SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
