"""Deterministic synthetic LM data pipeline — shardable and checkpointable.

Port of ``repro/data/pipeline.py`` (a copy of its numpy generator: the port
imports nothing of the reference).  Batch *i* is a pure function of (seed,
i), drawn with numpy exactly as the reference draws it, so the port's
batches are the reference's bit for bit; they come back as CPU tensors,
``tokens`` and ``targets`` int64 (the reference's int32 values) and
``loss_mask`` float32.  Each data-parallel host slices its rows without
coordination (:func:`host_batch_slice`), and the iterator's state is one
integer (the step), stored in a checkpoint and restored on resume.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

__all__ = ["DataConfig", "SyntheticLM", "make_batch", "host_batch_slice"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2  # power-law exponent for token frequencies
    doc_len_mean: int = 512


class SyntheticLM:
    """Deterministic batch generator with O(1) state (the step counter)."""

    def __init__(self, dcfg: DataConfig, start_step: int = 0):
        self.cfg = dcfg
        self.step = start_step

    def state(self) -> dict:
        return {"step": self.step, "seed": self.cfg.seed}

    @classmethod
    def restore(cls, dcfg: DataConfig, state: dict) -> "SyntheticLM":
        if state["seed"] != dcfg.seed:
            raise ValueError(f"data seed mismatch on restore: saved {state['seed']}, config {dcfg.seed}")
        return cls(dcfg, start_step=int(state["step"]))

    def batch_at(self, step: int) -> dict:
        return make_batch(self.cfg, step)

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        b = self.batch_at(self.step)
        self.step += 1
        return b


def _zipf_tokens(rng: np.random.Generator, cfg: DataConfig, shape) -> np.ndarray:
    # Inverse-CDF sampling of a bounded zipf over [4, vocab) (0-3 reserved).
    u = rng.random(shape)
    ranks = np.power(u, -1.0 / (cfg.zipf_a - 1.0))
    ranks = np.minimum(ranks, float(cfg.vocab_size))  # clip pre-cast (inf-safe)
    return np.clip(ranks.astype(np.int64), 1, cfg.vocab_size - 5) + 3


def make_batch(cfg: DataConfig, step: int) -> dict:
    """Pure function of (cfg.seed, step) → {'tokens', 'targets', 'loss_mask'}."""
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step]))
    b, s = cfg.global_batch, cfg.seq_len
    toks = _zipf_tokens(rng, cfg, (b, s + 1))
    # Document boundaries (token 2 = EOD) at geometric intervals; the loss
    # is masked right after them (the next token is unpredictable).
    eod_mask = rng.random((b, s + 1)) < (1.0 / cfg.doc_len_mean)
    toks = np.where(eod_mask, 2, toks)
    targets = toks[:, 1:]
    return {
        "tokens": torch.from_numpy(np.ascontiguousarray(toks[:, :-1])),
        "targets": torch.from_numpy(np.ascontiguousarray(targets)),
        "loss_mask": torch.from_numpy((targets != 2).astype(np.float32)),
    }


def host_batch_slice(batch: dict, host_index: int, num_hosts: int) -> dict:
    """Rows owned by one data-parallel host (deterministic, coordination-free)."""

    def one(x):
        per = x.shape[0] // num_hosts
        return x[host_index * per: (host_index + 1) * per]

    return {k: one(v) for k, v in batch.items()}
