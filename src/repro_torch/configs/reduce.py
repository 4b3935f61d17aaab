"""Reduced configs: same family/block structure, laptop-scale dimensions.

Used by the CPU tests, which hold the port against the reference at these
sizes; the full configs run on the card.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig
from repro_torch.models.stack import find_unit

__all__ = ["make_reduced"]


def make_reduced(cfg: ModelConfig, *, units: int = 2) -> ModelConfig:
    """Shrink every dimension while preserving the block pattern family."""
    if cfg.family == "fft":
        return cfg
    pattern = cfg.pattern()
    unit = find_unit(pattern)
    reps = min(units, len(pattern) // len(unit))
    new_pattern = tuple(unit) * reps

    heads = min(cfg.num_heads, 4)
    kv = min(cfg.num_kv_heads, heads)
    # keep the GQA group structure when the full config has one
    if cfg.num_kv_heads < cfg.num_heads:
        kv = max(1, heads // max(1, cfg.num_heads // cfg.num_kv_heads))
    d_model = 64
    changes = dict(
        num_layers=len(new_pattern) if not cfg.block_pattern else cfg.num_layers,
        block_pattern=new_pattern,
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=16,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab_size=512,
        num_experts=min(cfg.num_experts, 8) if cfg.num_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        num_shared_experts=min(cfg.num_shared_experts, 1),
        ssm_state=min(cfg.ssm_state, 8) if cfg.ssm_state else 0,
        ssm_heads=4 if cfg.ssm_heads else 0,
        chunk_size=8,
        sliding_window=8 if cfg.sliding_window else None,
        spectral_filter_len=16,
        frontend_len=4 if cfg.frontend_len else 0,
        mrope_sections=(4, 2, 2) if cfg.rope_kind == "mrope" else cfg.mrope_sections,
        attn_chunk=8,
        attn_chunk_threshold=64,
        loss_chunk=16,
        scan_layers=cfg.scan_layers,
        param_dtype="float32",
    )
    return dataclasses.replace(cfg, **changes)
