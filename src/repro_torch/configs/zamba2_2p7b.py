"""zamba2-2.7b: 54 Mamba2 layers, d_model=2560, ssm_state=64, + shared
attention blocks (32H, kv=32, d_ff=10240 MLP) every 6 Mamba2 layers.

[arXiv:2411.15242; hf]  Deviation noted in DESIGN §5: Zamba2's per-invocation
LoRA on the shared block is simplified to plain weight sharing.  Mamba2
inner dim 5120 → 80 heads of P=64.  long_500k: RUN — SSM state is O(1).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    ssm_heads=80,
    ssm_expand=2,
    chunk_size=256,
    shared_attn_every=6,
    block_pattern=(("mamba2",) * 6 + ("shared_attn",)) * 9,
)

SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
