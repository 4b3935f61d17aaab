"""The Mamba2 layer (``repro_torch.models.layers.ssm``), the ``mamba2`` and
``shared_attn`` blocks and zamba2-2.7b against the reference on the CPU.

The reference's parameters (``mamba2_init``, ``block_init``,
``init_unzipped`` at ``PRNGKey(0)``) go into the port; the same seeded numpy
inputs go through both at float32 compute.  Tolerances, relative to
max|ref|: the layer 1e-5 (forward, its cache, each decode step against the
reference's and the layer's own forward); whole models 1e-4 for logits and
gradients, 1e-3 for prefill + decode against the forward
(``tests/test_decode_equiv.py``'s bound).  The chunk rule and the masked
decay exponent (finite gradients at chunk 256, where the reference's are
NaN) are held here too.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as RefConfig
from repro.models import blocks as ref_blocks
from repro.models import model as ref_model
from repro.models.layers import ssm as ref_ssm
from repro.utils.params import unzip
from repro_torch.models import blocks
from repro_torch.models.layers import ssm
from repro_torch.utils.params import load_reference_params

from _recurrent import (check_model, check_training, model_pair, np_tree, port_cfg, port_grads, randn,
                        reduced, rel)

TOL = 1e-5

#: The reference's own hybrid case of ``tests/test_decode_equiv.py``.
ZAMBA_HYBRID = RefConfig(
    family="hybrid", d_model=64, num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=256, ssm_state=8,
    ssm_heads=4, chunk_size=2, block_pattern=("mamba2", "mamba2", "shared_attn") * 2, compute_dtype="float32",
)


def _layer(**changes):
    ref_cfg, cfg = reduced("zamba2-2.7b", **changes)
    params = np_tree(unzip(ref_ssm.mamba2_init(jax.random.PRNGKey(0), ref_cfg, jnp.float32))[0])
    return ref_cfg, params, load_reference_params(ssm.Mamba2(cfg, device="cpu"), params)


@pytest.mark.parametrize("b,s", [(3, 5), (3, 16), (1, 24)])
def test_mamba2_forward_and_decode_match_reference(b, s):
    """Forward with and without its cache (S below the chunk of 8 and whole
    chunks), then every decode step from an empty cache against the
    reference's ``mamba2_decode`` and the layer's own forward."""
    ref_cfg, params, layer = _layer()
    x = randn((b, s, 64), seed=s)
    yr, rc = ref_ssm.mamba2_forward(params, jnp.asarray(x), cfg=ref_cfg, return_cache=True)
    with torch.no_grad():
        y = layer(torch.from_numpy(x))
        y2, cache = layer(torch.from_numpy(x), return_cache=True)
    assert torch.equal(y, y2) and rel(y, yr) <= TOL
    assert rel(cache.state, rc.state) <= TOL and rel(cache.conv, rc.conv) <= TOL
    rc = ref_ssm.init_ssm_cache(ref_cfg, b, jnp.float32)
    cache = layer.init_cache(b)
    assert tuple(cache.state.shape) == rc.state.shape and tuple(cache.conv.shape) == rc.conv.shape
    step = jax.jit(lambda a, c: ref_ssm.mamba2_decode(params, a, c, cfg=ref_cfg))
    for t in range(s):
        yd_r, rc = step(jnp.asarray(x[:, t:t + 1]), rc)
        with torch.no_grad():
            yd, cache = layer.decode(torch.from_numpy(x[:, t:t + 1]), cache)
        assert rel(yd, yd_r) <= TOL and rel(yd[:, 0], y[:, t].numpy()) <= TOL, t
    assert rel(cache.state, rc.state) <= TOL


def test_mamba2_bf16_matches_reference():
    """bf16 activations (the weights cast at each use, the SSD in float32):
    within 5e-2 of the reference's bf16 forward."""
    ref_cfg, params, layer = _layer()
    x = randn((3, 16, 64), seed=2)
    yr = ref_ssm.mamba2_forward(params, jnp.asarray(x, jnp.bfloat16), cfg=ref_cfg)
    with torch.no_grad():
        y = layer(torch.from_numpy(x).bfloat16())
    assert y.dtype == torch.bfloat16 and rel(y, yr) <= 5e-2


def test_chunk_rule_is_the_reference():
    """Above the chunk (8) only whole chunks: both packages take 8 and 16
    positions and refuse 12 (the reference asserts, the port raises
    ``ValueError`` naming the rule); 5 and 24 are taken above."""
    ref_cfg, params, layer = _layer()
    for s in (8, 12, 16):
        x = randn((1, s, 64))
        ok = s <= 8 or s % 8 == 0
        if ok:
            ref_ssm.mamba2_forward(params, jnp.asarray(x), cfg=ref_cfg)
            with torch.no_grad():
                layer(torch.from_numpy(x))
            continue
        with pytest.raises(AssertionError):
            ref_ssm.mamba2_forward(params, jnp.asarray(x), cfg=ref_cfg)
        with pytest.raises(ValueError, match="chunk size 8"):
            layer(torch.from_numpy(x))
    assert ssm.chunks(37, 256) == (37, 1) and ssm.chunks(4096, 256) == (256, 16)


def test_masked_decay_exponent_keeps_gradients_finite_at_chunk_256():
    """A short, strongly decaying input (dt ≈ 3: a log decay of −3 … −48 a
    step) over one chunk of 256: the forward is the reference's, and every
    gradient is finite, where the reference's ``exp`` of the unmasked
    exponent overflows above the diagonal and its gradients of ``a_log``,
    ``dt_bias`` and ``w_in`` are NaN."""
    ref_cfg = RefConfig(family="hybrid", d_model=32, num_heads=2, num_kv_heads=2, ssm_state=8, ssm_heads=2,
                        chunk_size=256, compute_dtype="float32", block_pattern=("mamba2",))
    params = unzip(ref_ssm.mamba2_init(jax.random.PRNGKey(0), ref_cfg, jnp.float32))[0]
    params["dt_bias"] = jnp.full_like(params["dt_bias"], 3.0)
    layer = load_reference_params(ssm.Mamba2(port_cfg(ref_cfg), device="cpu"), np_tree(params))
    x = randn((1, 256, 32), seed=3)
    fwd = jax.jit(lambda p: ref_ssm.mamba2_forward(p, jnp.asarray(x), cfg=ref_cfg))
    ref_g = jax.jit(jax.grad(lambda p: fwd(p).sum()))(params)
    assert not all(bool(jnp.isfinite(v).all()) for v in ref_g.values() if not isinstance(v, dict))
    y = layer(torch.from_numpy(x))
    # 256-term contractions in another order: each side is 8e-6 from float64.
    assert rel(y, fwd(params)) <= 1e-4
    grads = torch.autograd.grad(y.sum(), list(layer.parameters()))
    assert all(bool(torch.isfinite(g).all()) for g in grads)


def test_mamba2_gradient_matches_jax_grad():
    """Every parameter's gradient of Σ y against ``jax.grad`` (two chunks)."""
    ref_cfg, params, layer = _layer()
    x = randn((3, 16, 64), seed=4)
    ref_g = jax.jit(jax.grad(lambda p: ref_ssm.mamba2_forward(p, jnp.asarray(x), cfg=ref_cfg).sum()))(params)
    names, ps = zip(*layer.named_parameters())
    for name, g in zip(names, torch.autograd.grad(layer(torch.from_numpy(x)).sum(), ps)):
        want = ref_g["norm"]["scale"] if name == "norm.scale" else ref_g[name]
        assert rel(g, want) <= 1e-4, name


@pytest.mark.parametrize("kind", ["mamba2", "shared_attn"])
def test_block_forward_and_decode_match_reference(kind):
    """``mamba2`` holds norm1 and mixer only; ``shared_attn`` is built as
    ``attn`` (a KV cache).  Forward with its cache, then every decode step
    against the reference's ``block_decode`` and the block's forward."""
    ref_cfg, cfg = reduced("zamba2-2.7b")
    params = np_tree(unzip(ref_blocks.block_init(jax.random.PRNGKey(0), kind, ref_cfg, jnp.float32))[0])
    block = load_reference_params(blocks.Block(kind, cfg, device="cpu"), params)
    want = {"norm1", "mixer"} if kind == "mamba2" else {"norm1", "mixer", "norm2", "mlp"}
    assert {n.split(".")[0] for n, _ in block.named_parameters()} == want
    b, s = 3, 16
    x = randn((b, s, 64), seed=5)
    pos = np.broadcast_to(np.arange(s), (b, s))
    yr, _, _ = ref_blocks.block_forward(params, jnp.asarray(x), kind=kind, cfg=ref_cfg, positions=jnp.asarray(pos),
                                        return_cache=True)
    with torch.no_grad():
        y, _, aux = block(torch.from_numpy(x), torch.from_numpy(pos.copy()), return_cache=True)
    assert rel(y, yr) <= TOL and float(aux) == 0
    rc = ref_blocks.block_cache_init(kind, ref_cfg, b, s, jnp.float32)
    cache = block.cache_init(b, s, torch.float32)
    step = jax.jit(lambda a, c, t: ref_blocks.block_decode(params, a, c, t, kind=kind, cfg=ref_cfg))
    for t in range(s):
        yd_r, rc = step(jnp.asarray(x[:, t:t + 1]), rc, jnp.asarray(t, jnp.int32))
        with torch.no_grad():
            yd, cache = block.decode(torch.from_numpy(x[:, t:t + 1]), cache, t)
        assert rel(yd, yd_r) <= TOL and rel(yd[:, 0], y[:, t].numpy()) <= TOL, t


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------


def test_shared_block_is_one_module():
    """zamba2's 63 layers: 54 ``mamba2`` modules and one shared attention
    block at the 9 ``shared_attn`` positions, its parameters once in
    ``named_parameters()`` and ``state_dict()`` as ``stack.shared.*``."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import DecoderLM

    model = DecoderLM(get_config("zamba2-2.7b"), device="meta")
    assert len(model.stack) == 63 and len(list(model.stack)) == 63
    shared = [i for i, blk in enumerate(model.stack) if blk.kind == "shared_attn"]
    assert shared == list(range(6, 63, 7)) and all(model.stack[i] is model.stack.shared for i in shared)
    names = [n for n, _ in model.named_parameters()]
    assert len(names) == len(set(names)) == len(model.state_dict())
    assert sum(n.startswith("stack.shared.") for n in names) == len(list(model.stack.shared.parameters()))
    assert not any(n.startswith(f"stack.{i}.") for n in names for i in shared)


@pytest.mark.parametrize("case", ["zamba2-2.7b", "zamba_hybrid"])
def test_model_matches_reference(case):
    """Reduced zamba2-2.7b (``(mamba2 × 6, shared_attn) × 2``, chunk 8) and
    the reference's ``zamba_hybrid`` case (chunk 2): logits at an odd batch
    over whole chunks, the prefill's decode states, and prefill + decode
    against the forward."""
    if case == "zamba2-2.7b":
        (ref_cfg, cfg), s, sp = reduced(case), 24, 8
    else:
        (ref_cfg, cfg), s, sp = (ZAMBA_HYBRID, port_cfg(ZAMBA_HYBRID)), 16, 10
    params, model = model_pair(ref_cfg, cfg)
    check_model(ref_cfg, params, model, b=3, s=s, sp=sp)


def test_training_matches_reference():
    """zamba2 reduced to one unit (``mamba2 × 6, shared_attn``): loss and
    gradients against ``jax.grad`` (the shared block's the reference's
    unstacked leaf), one AdamW step."""
    check_training(*reduced("zamba2-2.7b", units=1))


def test_shared_block_gradient_is_the_sum_over_its_uses():
    """The reduced zamba2 at one Mamba2 layer a unit, ``(mamba2,
    shared_attn) × 9``: the shared block's gradient over its 9 uses is the
    reference's unstacked leaf, and the sum of the gradients of 9 untied
    copies, one at each position."""
    ref_cfg, cfg = reduced("zamba2-2.7b", block_pattern=("mamba2", "shared_attn") * 9, remat=False)
    params, model = model_pair(ref_cfg, cfg)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, 512, (1, 8)), "targets": rng.integers(0, 512, (1, 8))}
    ref_g = jax.jit(jax.grad(lambda p: ref_model.loss_fn(p, jax.tree.map(jnp.asarray, batch), ref_cfg)[0]))(params)
    _, _, grads = port_grads(model, batch)
    shared = {n: g for n, g in grads.items() if n.startswith("stack.shared.")}
    assert len(shared) == len(list(model.stack.shared.parameters()))
    for name, g in shared.items():
        leaf = ref_g["stack"]["shared"]
        for part in name.split(".")[2:]:
            leaf = leaf[part]
        assert rel(g, leaf) <= 1e-4, name
    untied = copy.deepcopy(model)
    positions = [i for i, kind in enumerate(cfg.pattern()) if kind == "shared_attn"]
    for i in positions:
        untied.stack.add_module(str(i), copy.deepcopy(untied.stack.shared))
    untied.stack.pattern = tuple("attn" if k == "shared_attn" else k for k in untied.stack.pattern)
    del untied.stack.shared
    _, _, split = port_grads(untied, batch)
    for name, g in shared.items():
        rest = name[len("stack.shared."):]
        total = sum(split[f"stack.{i}.{rest}"] for i in positions)
        assert torch.allclose(g, total, rtol=0, atol=1e-6 * float(total.abs().max())), name
