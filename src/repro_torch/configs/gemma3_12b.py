"""gemma3-12b: 48L d_model=3840 16H (GQA kv=8) d_ff=15360 vocab=262144.

5:1 local(sliding-window 1024):global attention, 128k-class context.
[hf:google/gemma-3-*-pt; assignment tier: unverified — assignment numbers
are authoritative here.]  head_dim=256 (gemma3 uses wide heads).
long_500k: RUN — 40/48 layers are SWA-bounded; the 8 global layers decode
linearly per token with an SP-sharded KV cache (see DESIGN §5).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    num_layers=48,
    d_model=3840,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab_size=262144,
    act="gelu",
    sliding_window=1024,
    local_global_ratio=5,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    final_logit_softcap=30.0,
)

SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
