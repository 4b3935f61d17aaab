"""arctic-480b: 35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000.

MoE: 128 experts, top-2, with a dense residual MLP in parallel (arctic's
dense+MoE hybrid).  [hf:Snowflake/snowflake-arctic-base]
long_500k: SKIPPED — full attention.  Trains with adafactor + fsdp (480B
params would not fit per-chip optimizer state otherwise): the port's
sharded model (``repro_torch.sharding``) places it by the reference's
rules (its specs are held against the reference's), but 480 B parameters
need many cards, so the port runs it at reduced size only.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    num_experts=128,
    top_k=2,
    moe_dense_residual=True,
    param_dtype="bfloat16",
    kv_cache_dtype="int8",
)

SHAPES = ["train_4k", "prefill_32k", "decode_32k"]
