"""Config system: model and shape definitions.

Port of ``repro/configs/base.py``, a copy of its data: ``ModelConfig`` field
for field, ``ShapeConfig`` and ``LM_SHAPES``.  ``ParallelConfig`` (how
:mod:`repro_torch.sharding` maps logical axes onto a ``DeviceMesh``) and
``TrainConfig`` with the reference's defaults.  ``get_config(arch_id)`` resolves a registry name to
the ``ModelConfig`` in its own module under ``repro_torch.configs``.  The
registry knows every name the reference knows; ``fftbench``, the paper's
benchmark, raises ``NotImplementedError`` naming ``ROADMAP.md`` A1.

Of the execution fields the port reads ``compute_dtype``, ``param_dtype``,
``attn_chunk``, ``attn_chunk_threshold``, ``kv_cache_dtype``,
``loss_chunk`` (the chunked cross-entropy) and ``remat`` (each block
checkpointed in training); ``scan_layers`` and ``decode_cache_mode`` shape
the reference's XLA program and have no counterpart in eager PyTorch.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple

__all__ = [
    "ModelConfig",
    "ParallelConfig",
    "TrainConfig",
    "ShapeConfig",
    "LM_SHAPES",
    "get_config",
    "list_archs",
    "register",
]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # --- identity ------------------------------------------------------
    name: str = "unnamed"
    family: str = "dense"  # dense | moe | ssm | hybrid | audio | vlm
    # --- trunk ---------------------------------------------------------
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 0  # 0 → d_model // num_heads
    d_ff: int = 1024
    vocab_size: int = 32000
    act: str = "silu"  # silu (SwiGLU) | gelu (GeGLU)
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # --- attention -----------------------------------------------------
    sliding_window: Optional[int] = None  # window size for local layers
    local_global_ratio: int = 0  # e.g. 5 → pattern [local]*5 + [global]
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    rope_theta: float = 10000.0
    rope_kind: str = "standard"  # standard | mrope
    mrope_sections: Tuple[int, ...] = (16, 24, 24)
    # --- MoE -----------------------------------------------------------
    num_experts: int = 0
    top_k: int = 0
    num_shared_experts: int = 0
    moe_dense_residual: bool = False  # arctic: dense MLP in parallel
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.01
    # --- SSM / recurrent -----------------------------------------------
    ssm_state: int = 0          # Mamba2 d_state
    ssm_heads: int = 0          # Mamba2 / mLSTM heads (0 → num_heads)
    ssm_expand: int = 2         # Mamba2 expansion
    conv_width: int = 4         # Mamba2 short conv
    chunk_size: int = 256       # chunked linear-recurrence block length
    shared_attn_every: int = 0  # zamba2: shared transformer block cadence
    # --- block pattern (overrides the derived one when non-empty) -------
    block_pattern: Tuple[str, ...] = ()
    # --- modality frontend stubs ----------------------------------------
    frontend: Optional[str] = None  # audio | vision
    frontend_len: int = 0  # prefix positions fed by precomputed embeddings
    # --- paper integration ----------------------------------------------
    use_spectral_mixer: bool = False  # swap attention for FFT long-conv
    spectral_filter_len: int = 1024
    # Spectral decode state: "stream" carries the overlap-save tail + a
    # chunk accumulator and flushes through the cached block plan once per
    # chunk (amortized FFT decode); "ring" is the O(Lf·D)-per-token direct
    # dot (the exactness oracle).  spectral_decode_chunk=0 → sized from the
    # filter (max(8, next_pow2(Lf)/4)).
    spectral_decode_mode: str = "stream"  # stream | ring
    spectral_decode_chunk: int = 0
    # --- numerics / execution -------------------------------------------
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True
    attn_chunk: int = 1024      # q-block size for chunked attention
    attn_chunk_threshold: int = 2048  # S above this uses chunked attention
    kv_cache_dtype: str = "bf16"  # bf16 | int8 (quantized decode cache)
    decode_cache_mode: str = "carry"  # carry | ys (scan cache passing; §Perf)
    loss_chunk: int = 512       # vocab-loss sequence chunking

    # --- derived ---------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def resolved_ssm_heads(self) -> int:
        return self.ssm_heads or self.num_heads

    def pattern(self) -> Tuple[str, ...]:
        """Per-layer block kinds (the scan stack consumes this)."""
        if self.block_pattern:
            return self.block_pattern
        if self.family in ("dense", "audio", "vlm", "moe"):
            kind = "moe" if self.family == "moe" else "attn"
            if self.use_spectral_mixer:
                # paper-integration ablation: alternate FFT long-conv mixing
                # with attention (Hyena-style hybrid).
                assert self.num_layers % 2 == 0, self.num_layers
                return ("spectral", kind) * (self.num_layers // 2)
            if self.local_global_ratio:
                unit = ["attn_local"] * self.local_global_ratio + ["attn"]
                reps = self.num_layers // len(unit)
                assert reps * len(unit) == self.num_layers, (
                    self.num_layers,
                    len(unit),
                )
                return tuple(unit) * reps
            if self.sliding_window and not self.local_global_ratio:
                return ("attn_local",) * self.num_layers
            return (kind,) * self.num_layers
        raise ValueError(
            f"family {self.family!r} must set block_pattern explicitly"
        )


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """How logical axes map onto the mesh: the reference's fields and
    defaults.  :mod:`repro_torch.sharding` reads the axes, ``pod_axis``,
    ``fsdp``, ``sequence_parallel`` and ``decode_weight_stationary`` (the
    rules); the sharded model trains on a (data, model) mesh
    (``launch/train.py --mesh DxM``); ``remat_policy`` shapes the
    reference's XLA program (the port's remat is ``ModelConfig.remat``)."""

    data_axis: str = "data"
    model_axis: str = "model"
    pod_axis: Optional[str] = None  # present on the multi-pod mesh
    fsdp: bool = False              # shard params over the data axis too
    sequence_parallel: bool = False  # shard long KV caches over data
    remat_policy: str = "minimal"   # minimal | full | none
    decode_weight_stationary: bool = False


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: str = "adamw"  # adamw | adafactor | sgd
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    grad_clip: float = 1.0
    batch_size: int = 8
    seq_len: int = 512
    microbatches: int = 1        # gradient accumulation
    grad_compression: bool = False  # int8 + error feedback
    z_loss: float = 1e-4
    seed: int = 0
    checkpoint_every: int = 100
    keep_checkpoints: int = 3


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


LM_SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


#: Registry names whose configurations the port resolves.
_REGISTRY: dict[str, str] = {
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "deepseek-moe-16b": "repro_torch.configs.deepseek_moe_16b",
    "gemma3-12b": "repro_torch.configs.gemma3_12b",
    "h2o-danube-1.8b": "repro_torch.configs.h2o_danube_1p8b",
    "yi-6b": "repro_torch.configs.yi_6b",
    "phi4-mini-3.8b": "repro_torch.configs.phi4_mini_3p8b",
    "zamba2-2.7b": "repro_torch.configs.zamba2_2p7b",
    "xlstm-125m": "repro_torch.configs.xlstm_125m",
    "musicgen-large": "repro_torch.configs.musicgen_large",
    "qwen2-vl-72b": "repro_torch.configs.qwen2_vl_72b",
}

#: The reference's other registry name: the paper's benchmark.
_NOT_PORTED = ("fftbench",)

_EXTRA: dict[str, ModelConfig] = {}


def register(name: str, cfg: ModelConfig) -> None:
    _EXTRA[name] = cfg


def list_archs() -> list[str]:
    """The registry names :func:`get_config` resolves."""
    return list(_REGISTRY)


def get_config(arch: str) -> ModelConfig:
    if arch in _EXTRA:
        return _EXTRA[arch]
    if arch in _NOT_PORTED:
        raise NotImplementedError(f"arch {arch!r} is not ported yet: it waits for the paper's benchmark, "
                                  f"ROADMAP.md A1; ported: {sorted(_REGISTRY)}")
    if arch not in _REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_REGISTRY) + sorted(_NOT_PORTED)}")
    return importlib.import_module(_REGISTRY[arch]).CONFIG
