"""deepseek-moe-16b: 28L d_model=2048 16H (kv=16) d_ff=1408 vocab=102400.

Fine-grained MoE: 64 routed experts top-6 + 2 shared experts.
[arXiv:2401.06066; hf]  long_500k: SKIPPED — full attention.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    num_experts=64,
    top_k=6,
    num_shared_experts=2,
)

SHAPES = ["train_4k", "prefill_32k", "decode_32k"]
