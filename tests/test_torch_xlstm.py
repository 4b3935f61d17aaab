"""The mLSTM and sLSTM layers (``repro_torch.models.layers.xlstm``), their
blocks and xlstm-125m against the reference on the CPU.

The reference's parameters (``mlstm_init``, ``slstm_init``,
``init_unzipped`` at ``PRNGKey(0)``) go into the port; the same seeded numpy
inputs go through both at float32 compute.  Tolerances, relative to
max|ref|: the layers 1e-5 (forward, its cache, each decode step against the
reference's and the layer's own forward); whole models 1e-4 for logits and
gradients, 1e-3 for prefill + decode against the forward.  The stabiliser
scan is held against ``lax.associative_scan`` and a float64 recurrence.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as RefConfig
from repro.models import blocks as ref_blocks
from repro.models.layers import xlstm as ref_xlstm
from repro.utils.params import unzip
from repro_torch.models import blocks
from repro_torch.models.layers import xlstm
from repro_torch.utils.params import load_reference_params

from _recurrent import check_model, check_training, model_pair, np_tree, port_cfg, randn, reduced, rel

TOL = 1e-5

#: The reference's own xLSTM case of ``tests/test_decode_equiv.py``.
XLSTM_CASE = RefConfig(
    family="ssm", d_model=64, num_heads=4, num_kv_heads=4, d_ff=0, vocab_size=256, ssm_heads=2, chunk_size=2,
    block_pattern=("mlstm", "slstm") * 2, compute_dtype="float32",
)

LAYERS = {
    "mlstm": (ref_xlstm.mlstm_init, ref_xlstm.mlstm_forward, ref_xlstm.mlstm_decode, xlstm.MLSTM),
    "slstm": (ref_xlstm.slstm_init, ref_xlstm.slstm_forward, ref_xlstm.slstm_decode, xlstm.SLSTM),
}


def _layer(kind):
    init, fwd, dec, cls = LAYERS[kind]
    ref_cfg, cfg = reduced("xlstm-125m")
    params = np_tree(unzip(init(jax.random.PRNGKey(0), ref_cfg, jnp.float32))[0])
    return ref_cfg, params, load_reference_params(cls(cfg, device="cpu"), params)


@pytest.mark.parametrize("kind,b,s", [("mlstm", 3, 5), ("mlstm", 3, 16), ("slstm", 3, 5), ("slstm", 1, 16)])
def test_layer_forward_and_decode_match_reference(kind, b, s):
    """Forward with and without its cache (S below the chunk of 8 and whole
    chunks), then every decode step from an empty cache against the
    reference's decode and the layer's own forward."""
    _, fwd, dec, _ = LAYERS[kind]
    ref_cfg, params, layer = _layer(kind)
    x = randn((b, s, 64), seed=s)
    yr, rc = jax.jit(lambda a: fwd(params, a, cfg=ref_cfg, return_cache=True))(jnp.asarray(x))
    with torch.no_grad():
        y = layer(torch.from_numpy(x))
        y2, cache = layer(torch.from_numpy(x), return_cache=True)
    assert torch.equal(y, y2) and rel(y, yr) <= TOL
    for name, a in cache._asdict().items():
        assert rel(a, getattr(rc, name)) <= TOL, name
    init_cache = ref_xlstm.init_mlstm_cache if kind == "mlstm" else ref_xlstm.init_slstm_cache
    rc, cache = init_cache(ref_cfg, b), layer.init_cache(b)
    for name, a in cache._asdict().items():
        assert np.array_equal(a.numpy(), np.asarray(getattr(rc, name))), name
    step = jax.jit(lambda a, c: dec(params, a, c, cfg=ref_cfg))
    for t in range(s):
        yd_r, rc = step(jnp.asarray(x[:, t:t + 1]), rc)
        with torch.no_grad():
            yd, cache = layer.decode(torch.from_numpy(x[:, t:t + 1]), cache)
        assert rel(yd, yd_r) <= TOL and rel(yd[:, 0], y[:, t].numpy()) <= TOL, t


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_layer_bf16_and_gradient_match_reference(kind):
    """bf16 activations within 5e-2 of the reference's; every parameter's
    gradient of Σ y (float32, two chunks) against ``jax.grad``."""
    _, fwd, _, _ = LAYERS[kind]
    ref_cfg, params, layer = _layer(kind)
    x = randn((3, 16, 64), seed=2)
    yr = jax.jit(lambda a: fwd(params, a, cfg=ref_cfg))(jnp.asarray(x, jnp.bfloat16))
    with torch.no_grad():
        y = layer(torch.from_numpy(x).bfloat16())
    assert y.dtype == torch.bfloat16 and rel(y, yr) <= 5e-2
    ref_g = jax.jit(jax.grad(lambda p: fwd(p, jnp.asarray(x), cfg=ref_cfg).sum()))(params)
    names, ps = zip(*layer.named_parameters())
    for name, g in zip(names, torch.autograd.grad(layer(torch.from_numpy(x)).sum(), ps)):
        want = ref_g["norm"]["scale"] if name == "norm.scale" else ref_g[name]
        assert rel(g, want) <= 1e-4, name


@pytest.mark.parametrize("s", [64, 4096])
def test_stabiliser_scan(s):
    """``stab_scan`` (cumsum and cummax) against the reference's
    ``lax.associative_scan`` and a float64 recurrence: within 2e-6 at S = 64
    and 1e-4 at 4096 of the reference (the cumulative sum's rounding; the
    reference's tree is 5e-7 from float64), and within 2e-4·S/4096 + 4e-6
    of float64.  The layer's output does not depend on m in exact
    arithmetic (it cancels between C, n and the floor e^{−m})."""
    rng = np.random.default_rng(0)
    li = rng.standard_normal((3, s, 4)).astype(np.float32)
    lf = np.array(jax.nn.log_sigmoid(jnp.asarray(3 + 2 * rng.standard_normal((3, s, 4)), jnp.float32)))
    m0 = rng.standard_normal((3, 4)).astype(np.float32)
    ref = np.asarray(ref_xlstm._stab_scan(jnp.asarray(li), jnp.asarray(lf), jnp.asarray(m0)))
    got = xlstm.stab_scan(torch.from_numpy(li), torch.from_numpy(lf), torch.from_numpy(m0)).numpy()
    m, exact = m0.astype(np.float64), []
    for t in range(s):
        m = np.maximum(lf[:, t] + m, li[:, t])
        exact.append(m)
    exact = np.stack(exact, 1)
    assert np.abs(got - ref).max() <= (2e-6 if s == 64 else 1e-4)
    assert np.abs(got - exact).max() <= 2e-4 * s / 4096 + 4e-6


def test_chunk_rule_and_masked_exponent():
    """The mLSTM's chunk rule is the reference's (12 positions refused, 16
    taken); at chunk 256 over a strongly forgetting input (forget gates near
    0, log decay ≈ −10 a step) the forward is the reference's and every
    gradient finite."""
    ref_cfg, params, layer = _layer("mlstm")
    x = randn((1, 12, 64))
    with pytest.raises(AssertionError):
        ref_xlstm.mlstm_forward(params, jnp.asarray(x), cfg=ref_cfg)
    with pytest.raises(ValueError, match="chunk size 8"):
        layer(torch.from_numpy(x))
    ref_cfg = RefConfig(family="ssm", d_model=32, num_heads=2, num_kv_heads=2, d_ff=0, ssm_heads=2, chunk_size=256,
                        compute_dtype="float32", block_pattern=("mlstm",))
    params = unzip(ref_xlstm.mlstm_init(jax.random.PRNGKey(0), ref_cfg, jnp.float32))[0]
    params["b_if"] = params["b_if"].at[2:].set(-10.0)
    layer = load_reference_params(xlstm.MLSTM(port_cfg(ref_cfg), device="cpu"), np_tree(params))
    x = randn((1, 256, 32), seed=3)
    y = layer(torch.from_numpy(x))
    assert rel(y, jax.jit(lambda p: ref_xlstm.mlstm_forward(p, jnp.asarray(x), cfg=ref_cfg))(params)) <= 1e-4
    grads = torch.autograd.grad(y.sum(), list(layer.parameters()))
    assert all(bool(torch.isfinite(g).all()) for g in grads)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_matches_reference(kind):
    """``mlstm`` holds norm1 and mixer only; ``slstm`` norm1, mixer, norm2
    and an MLP of 2·D (d_ff 0).  Forward and every decode step against the
    reference's ``block_forward`` / ``block_decode``."""
    ref_cfg, cfg = reduced("xlstm-125m")
    params = np_tree(unzip(ref_blocks.block_init(jax.random.PRNGKey(0), kind, ref_cfg, jnp.float32))[0])
    block = load_reference_params(blocks.Block(kind, cfg, device="cpu"), params)
    want = {"norm1", "mixer"} if kind == "mlstm" else {"norm1", "mixer", "norm2", "mlp"}
    assert {n.split(".")[0] for n, _ in block.named_parameters()} == want
    if kind == "slstm":
        assert tuple(block.mlp.wo.shape) == (128, 64)
    b, s = 3, 8
    x = randn((b, s, 64), seed=5)
    pos = jnp.broadcast_to(jnp.arange(s), (b, s))
    yr, _, _ = ref_blocks.block_forward(params, jnp.asarray(x), kind=kind, cfg=ref_cfg, positions=pos)
    with torch.no_grad():
        y, cache, aux = block(torch.from_numpy(x), torch.arange(s).expand(b, s))
    assert cache is None and float(aux) == 0 and rel(y, yr) <= TOL
    rc, cache = ref_blocks.block_cache_init(kind, ref_cfg, b, s, jnp.float32), block.cache_init(b, s, torch.float32)
    step = jax.jit(lambda a, c, t: ref_blocks.block_decode(params, a, c, t, kind=kind, cfg=ref_cfg))
    for t in range(s):
        yd_r, rc = step(jnp.asarray(x[:, t:t + 1]), rc, jnp.asarray(t, jnp.int32))
        with torch.no_grad():
            yd, cache = block.decode(torch.from_numpy(x[:, t:t + 1]), cache, t)
        assert rel(yd, yd_r) <= TOL and rel(yd[:, 0], y[:, t].numpy()) <= TOL, t


@pytest.mark.parametrize("case", ["xlstm-125m", "xlstm"])
def test_model_matches_reference(case):
    """Reduced xlstm-125m (``(mlstm, mlstm, slstm) × 2``, chunk 8) and the
    reference's ``xlstm`` case (chunk 2): logits at an odd batch over whole
    chunks, the prefill's decode states, and prefill + decode against the
    forward."""
    if case == "xlstm-125m":
        (ref_cfg, cfg), s, sp = reduced(case), 24, 8
    else:
        (ref_cfg, cfg), s, sp = (XLSTM_CASE, port_cfg(XLSTM_CASE)), 16, 10
    params, model = model_pair(ref_cfg, cfg)
    check_model(ref_cfg, params, model, b=3, s=s, sp=sp)


def test_training_matches_reference():
    """xlstm-125m reduced to one unit (``mlstm, mlstm, slstm``): loss and
    gradients against ``jax.grad``, one AdamW step."""
    check_training(*reduced("xlstm-125m", units=1))
