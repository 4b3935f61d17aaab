"""xlstm-125m: 12L d_model=768 4H d_ff=0 vocab=50304.

sLSTM + mLSTM blocks (xLSTM, arXiv:2405.04517; unverified).  d_ff=0 →
the blocks carry their own projections (mLSTM: expand-2 up/down; sLSTM
block gets a 2·D gated FFN).  Pattern: (mLSTM, mLSTM, sLSTM) × 4.
long_500k: RUN — recurrent state, O(1) per decoded token.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    ssm_heads=4,
    ssm_expand=2,
    chunk_size=256,
    block_pattern=("mlstm", "mlstm", "slstm") * 4,
)

SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
