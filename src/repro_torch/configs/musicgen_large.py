"""musicgen-large: 48L d_model=2048 32H (kv=32) d_ff=8192 vocab=2048.

Decoder-only transformer over EnCodec tokens.  [arXiv:2306.05284; hf]
Backbone only, as the reference's: the EnCodec frontend is a stub — the
caller passes precomputed frame embeddings (B, S, d_model) as
``frame_embeds=``; the 4-codebook interleaving is reduced to a single
2048-token stream.
long_500k: SKIPPED — full attention.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    frontend="audio",
)

SHAPES = ["train_4k", "prefill_32k", "decode_32k"]
