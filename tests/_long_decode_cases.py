"""Cases of ``test_torch_long_decode.py``: a reduced model, how it is
sharded on the 2×2 mesh, its batch and how its decode starts.  Both sides —
the four gloo ranks (sharded) and one device — run :func:`run` on the
reference's weights the test process saves.

``filled`` cases decode ``STEPS`` steps at the end of caches of ``SLOTS``
positions whose every slot is filled from a numpy seed (:func:`fill`; each
rank takes its shard of the same contents), as a long context's decode
does without its prefill; ``prompt`` cases prefill ``PROMPT`` tokens, then
decode ``STEPS`` teacher-forced steps.
"""

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.configs.reduce import make_reduced
from repro_torch.models.layers.attention import KVCache
from repro_torch.models.model import DecoderLM
from repro_torch.sharding import shard

SLOTS, PROMPT, STEPS = 256, 16, 4
MESH = (2, 2)


def _cfg(arch: str, spectral: bool = False, **changes):
    cfg = make_reduced(dataclasses.replace(get_config(arch), use_spectral_mixer=spectral))
    return dataclasses.replace(cfg, compute_dtype="float32", **changes)


#: gemma3-12b's pattern with one kv head: at 2×2 the kv heads do not
#: divide ``model``, so a batch of one splits the slots over (data, model).
GEMMA = _cfg("gemma3-12b", num_kv_heads=1)

#: name → (config, fsdp, weight-stationary decode, batch, how the decode starts)
CASES = {
    "gemma-seq-ws": (GEMMA, True, True, 1, "filled"),
    "gemma-seq": (GEMMA, False, False, 1, "filled"),
    "gemma-seq-int8-ws": (dataclasses.replace(GEMMA, kv_cache_dtype="int8"), True, True, 1, "filled"),
    "deepseek-ws-b1": (_cfg("deepseek-moe-16b"), True, True, 1, "prompt"),
    "deepseek-ws-b4": (_cfg("deepseek-moe-16b"), True, True, 4, "prompt"),
    "zamba2-ws-b1": (_cfg("zamba2-2.7b"), True, True, 1, "prompt"),
    "zamba2-ws-b4": (_cfg("zamba2-2.7b"), True, True, 4, "prompt"),
    "xlstm-b1": (_cfg("xlstm-125m"), False, False, 1, "prompt"),
    "xlstm-ws-b1": (_cfg("xlstm-125m"), True, True, 1, "prompt"),
    "xlstm-ws-b4": (_cfg("xlstm-125m"), True, True, 4, "prompt"),
    "h2o-spectral-ws-b4": (_cfg("h2o-danube-1.8b", True), True, True, 4, "prompt"),
}

#: The weight-stationary cases whose steps gather weights over ``data``:
#: the sLSTM's and the spectral filter (``shard.WS_GATHERED``).
WS_GATHERS = ("xlstm-ws-b1", "xlstm-ws-b4", "h2o-spectral-ws-b4")

#: The weights each case loads (cases that share a config share them).
WEIGHTS = {name: f"{cfg.name}-{cfg.num_kv_heads}-{cfg.kv_cache_dtype}-{cfg.use_spectral_mixer}"
           for name, (cfg, *_) in CASES.items()}


def model(cfg, weights: str = None) -> DecoderLM:
    """``cfg``'s model on the CPU, with the parameters saved at ``weights``
    (a ``state_dict``) where given."""
    m = DecoderLM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    if weights is not None:
        m.load_state_dict(torch.load(weights))
    return m


def tokens(cfg, batch: int) -> np.ndarray:
    """(batch, PROMPT + STEPS) ids from a seed (the same first rows at any
    batch)."""
    return np.random.default_rng(1).integers(0, cfg.vocab_size, (4, PROMPT + STEPS))[:batch]


def fill(cfg, batch: int) -> list:
    """Every layer's cache for ``batch`` rows and SLOTS positions, each slot
    filled from a seed: float32 keys and values, or int8 ones with their
    scales."""
    rng = np.random.default_rng(7)
    out = []
    for cache in DecoderLM(cfg, device="meta").cache_init(batch, SLOTS):
        shape = tuple(cache.k.shape)
        if cfg.kv_cache_dtype == "int8":
            kv = [torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8)) for _ in range(2)]
            sc = [torch.from_numpy(rng.uniform(0.004, 0.03, shape[:3]).astype(np.float32)) for _ in range(2)]
            out.append(KVCache(kv[0], kv[1], sc[0], sc[1]))
        else:
            out.append(KVCache(*[torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) for _ in range(2)]))
    return out


def start(m: DecoderLM, name: str, ids: np.ndarray):
    """(the caches the steps start from, the first position written): the
    filled caches (a sharded model's shard of them), or the prompt's
    prefill in decode layout."""
    cfg, _, _, batch, how = CASES[name]
    if how == "filled":
        caches = fill(cfg, batch)
        if shard.is_sharded(m):
            from repro_torch.launch.shardings import local_caches

            caches = [type(c)(*[t.clone() if torch.is_tensor(t) else t for t in c]) for c in local_caches(m, caches)]
        return caches, SLOTS - STEPS
    _, caches = m.prefill(shard.data_rows(m, torch.as_tensor(ids[:, :PROMPT])))
    return m.prepare_decode_caches(caches, PROMPT + STEPS), PROMPT


def run(m: DecoderLM, name: str) -> dict:
    """STEPS decode steps of ``name`` (this rank's rows, or all of them
    where the step replicates its batch), fed the ids after the prompt at
    positions from the first written: each step's logits (STEPS, rows,
    vocab), the caches after them, and each step's collectives (by kind, by
    kind and axis) with ``shard.decode_collectives`` of the step."""
    cfg, _, _, batch, _ = CASES[name]
    ids = tokens(cfg, batch)
    caches, t0 = start(m, name, ids)
    logits, counts, by_axis, predicted = [], [], [], []
    toks = shard.data_rows(m, torch.as_tensor(ids), decode=True)
    for i in range(STEPS):
        shard.reset_counts()
        out, caches = m.decode_step(toks[:, PROMPT + i], caches, t0 + i)
        logits.append(out.numpy())
        c = shard.counts()
        counts.append(c["counts"])
        by_axis.append(c["by_axis"])
        if shard.is_sharded(m):
            predicted.append(shard.decode_collectives(m, caches, toks.shape[0]))
    return {"logits": np.stack(logits), "caches": caches, "counts": counts, "by_axis": by_axis,
            "predicted": predicted}
