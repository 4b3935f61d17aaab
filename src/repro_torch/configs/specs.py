"""input_specs(): meta-tensor stand-ins for every model input.

Port of ``src/repro/configs/specs.py``.  The reference lowers against
``ShapeDtypeStruct``s; the port's dry run (:mod:`repro_torch.launch.dryrun`)
takes tensors on the ``meta`` device, which carry a shape and a dtype and
allocate nothing, and makes its fake inputs from them.  Token ids are
int64, as the port's batches are (the reference's int32).  For decode
shapes the specs include every layer's cache, built by
:meth:`repro_torch.models.model.DecoderLM.cache_init` on a model on the
meta device.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig

__all__ = ["input_specs", "decode_state_specs"]


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Model-input meta tensors for a train or prefill batch."""
    b, s = shape.global_batch, shape.seq_len
    cd = getattr(torch, cfg.compute_dtype)
    specs: dict = {}
    if cfg.frontend == "audio":
        # EnCodec frontend stub: precomputed frame embeddings.
        specs["frame_embeds"] = _meta((b, s, cfg.d_model), cd)
    else:
        specs["tokens"] = _meta((b, s), torch.int64)
    if cfg.frontend == "vision":
        fl = min(cfg.frontend_len, s)
        specs["vision_embeds"] = _meta((b, fl, cfg.d_model), cd)
        specs["mrope_positions"] = _meta((b, 3, s), torch.int64)
    if shape.kind == "train":
        specs["targets"] = _meta((b, s), torch.int64)
    return specs


def decode_state_specs(cfg: ModelConfig, shape: ShapeConfig, dtype=torch.bfloat16):
    """(token spec, cache specs, t spec) for a decode-step trace: the
    previous tokens (B,), every layer's cache for B rows of ``seq_len``
    positions (KV in ``dtype``), and the 0-d position."""
    from repro_torch.models.model import DecoderLM

    b, s = shape.global_batch, shape.seq_len
    caches = DecoderLM(cfg, device="meta").cache_init(b, s, dtype=dtype)
    return _meta((b,), torch.int64), caches, _meta((), torch.int64)
