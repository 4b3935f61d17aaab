"""qwen2-vl-72b: 80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064.

M-RoPE (sections 16/24/24 over the 64-dim rotary half), dynamic-resolution
vision.  [arXiv:2409.12191; hf]  Backbone only, as the reference's: the ViT
frontend is a stub — the caller passes precomputed patch embeddings for the
first ``frontend_len`` positions (``vision_embeds=``) and (B, 3, S) M-RoPE
position ids (``mrope_positions=``).
long_500k: SKIPPED — full attention.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    rope_theta=1_000_000.0,
    rope_kind="mrope",
    mrope_sections=(16, 24, 24),
    frontend="vision",
    frontend_len=1024,
    kv_cache_dtype="int8",
)

SHAPES = ["train_4k", "prefill_32k", "decode_32k"]
