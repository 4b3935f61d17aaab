"""Cases of ``test_torch_sharded_serve.py``: a reduced model, a mesh, and
the serving run both sides make — a prefill of ``ROWS`` prompts of
``PROMPT`` tokens, then ``STEPS`` teacher-forced decode steps — by the four
gloo ranks (sharded, each rank its rows) and by the test process (one
device, every row), on the reference's weights the test process saves."""

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.configs.reduce import make_reduced
from repro_torch.models.model import DecoderLM
from repro_torch.sharding import shard

ROWS, PROMPT, STEPS = 4, 16, 10  # 10 steps: one stream flush at the grain of 8


def _cfg(arch: str, spectral: bool = False):
    cfg = make_reduced(dataclasses.replace(get_config(arch), use_spectral_mixer=spectral))
    return dataclasses.replace(cfg, compute_dtype="float32")


#: name → (model config, mesh shape, fsdp)
CASES = {
    "h2o-spectral-2x2-fsdp": (_cfg("h2o-danube-1.8b", True), (2, 2), True),
    "h2o-spectral-1x4": (_cfg("h2o-danube-1.8b", True), (1, 4), False),
    "deepseek-spectral-2x2": (_cfg("deepseek-moe-16b", True), (2, 2), False),
    "zamba2-2x2-fsdp": (_cfg("zamba2-2.7b"), (2, 2), True),
    "qwen2-int8-1x4": (_cfg("qwen2-vl-72b"), (1, 4), False),
}


def model(cfg, weights: str = None) -> DecoderLM:
    """``cfg``'s model on the CPU, with the parameters saved at ``weights``
    (a ``state_dict``) where given."""
    m = DecoderLM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    if weights is not None:
        m.load_state_dict(torch.load(weights))
    return m


def tokens(cfg) -> np.ndarray:
    """(ROWS, PROMPT + STEPS) ids from a seed: the prompts, then the tokens
    fed to the decode steps."""
    return np.random.default_rng(1).integers(0, cfg.vocab_size, (ROWS, PROMPT + STEPS))


def serve(m: DecoderLM, ids: np.ndarray) -> tuple:
    """(prefill logits, per-step decode logits (STEPS, rows, vocab), the
    collectives of the prefill and of the last decode step) of ``m`` on
    its rows of ``ids``."""
    toks = shard.data_rows(m, torch.as_tensor(ids))
    shard.reset_counts()
    logits, caches = m.prefill(toks[:, :PROMPT])
    prefill_coll = shard.counts()["counts"]
    caches = m.prepare_decode_caches(caches, PROMPT + STEPS)
    steps = []
    for i in range(STEPS):
        shard.reset_counts()
        out, caches = m.decode_step(toks[:, PROMPT + i], caches, PROMPT + i)
        steps.append(out.numpy())
    return logits.numpy(), np.stack(steps), prefill_coll, shard.counts()["counts"]
