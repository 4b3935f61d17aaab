"""The MoE layer (``repro_torch.models.layers.moe``) and the ``moe`` block
against the reference's ``moe_apply`` / ``block_forward`` on the CPU.

The reference's parameters (``moe_init`` at ``PRNGKey(0)``) go into the port
through ``load_reference_params``; the same seeded numpy inputs go through
both.  Tolerance: 1e-4·max|ref| for outputs, the aux loss and gradients at
float32 compute, 5e-2·max|ref| at bfloat16 compute (each side rounds its own
intermediate products).  The routing itself is held exactly: the expert
indices, in order, and the ``keep`` masks are the reference's (computed with
the reference's own ops from ``moe_apply``), and so is the dropped count.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as RefConfig
from repro.models import blocks as ref_blocks
from repro.models.layers import attention as ref_attn
from repro.models.layers import moe as ref_moe
from repro.utils.params import unzip
from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks
from repro_torch.models.layers.moe import MoE, _capacity
from repro_torch.utils.params import load_reference_params

TOL = 1e-4
TOL_BF16 = 5e-2

#: deepseek-moe-16b's routing (64 experts, top-6, 2 shared) and
#: arctic-480b's (8 of its 128 experts, top-2, the dense residual), narrow.
CASES = {
    "deepseek": dict(num_experts=64, top_k=6, num_shared_experts=2),
    "arctic": dict(num_experts=8, top_k=2, moe_dense_residual=True),
    "drops": dict(num_experts=64, top_k=6, num_shared_experts=2, capacity_factor=0.01),
}


def _cfgs(case, **changes):
    kw = dict(family="moe", d_model=32, d_ff=16, compute_dtype="float32", **CASES[case], **changes)
    ref, port = RefConfig(**kw), ModelConfig(**kw)
    assert dataclasses.asdict(ref) == dataclasses.asdict(port)
    return ref, port


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _rel(got, ref):
    got = got.detach().double().numpy() if torch.is_tensor(got) else np.asarray(got, np.float64)
    ref = np.asarray(jnp.asarray(ref, jnp.float32), np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


def _ref_routing(params, x, cfg):
    """The reference's expert indices (B, S, k) and ``keep`` (B, S·k): the
    routing lines of ``moe_apply`` (``moe.py:84–101``) with its own ops."""
    b, s, _ = x.shape
    logits = jnp.einsum("gtd,de->gte", x.astype(jnp.float32), params["router"])
    _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), cfg.top_k)
    onehot = jax.nn.one_hot(idx.reshape(b, s * cfg.top_k), cfg.num_experts, dtype=jnp.int32)
    pos = ((jnp.cumsum(onehot, axis=1) - 1) * onehot).sum(-1)
    return np.asarray(idx), np.asarray(pos < ref_moe._capacity(s, cfg))


@pytest.fixture(scope="module", params=list(CASES))
def pair(request):
    ref_cfg, cfg = _cfgs(request.param)
    params, _ = unzip(ref_moe.moe_init(jax.random.PRNGKey(0), ref_cfg, jnp.float32))
    params = jax.tree.map(np.asarray, params)
    return request.param, ref_cfg, params, load_reference_params(MoE(cfg, device="cpu"), params)


def _check(pair, x, tol=TOL, dtype=torch.float32):
    """The port against the reference on ``x``: y, aux, the routing and the
    dropped count; returns the port's dropped count."""
    _, ref_cfg, params, m = pair
    jx = jnp.asarray(x, jnp.float32).astype(jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    y_ref, aux_ref = jax.jit(lambda p, a: ref_moe.moe_apply(p, a, cfg=ref_cfg))(params, jx)
    tx = torch.from_numpy(x).to(dtype)
    with torch.no_grad():
        y, aux = m(tx)
        routing = m.route(tx)
    assert y.dtype == dtype and aux.dtype == torch.float32 and aux.shape == ()
    assert _rel(y, y_ref) <= tol
    assert _rel(aux, aux_ref) <= tol
    idx, keep = _ref_routing(params, jx, ref_cfg)
    np.testing.assert_array_equal(routing.idx.numpy(), idx)
    np.testing.assert_array_equal(routing.keep.numpy(), keep)
    assert routing.capacity == ref_moe._capacity(x.shape[1], ref_cfg)
    assert int(m.dropped) == int((~keep).sum())
    return int(m.dropped)


def test_moe_matches_reference(pair):
    """(3, 40) rows: 40·k assignments a row at each case's capacity per
    row (deepseek's and the drop case's 8 slots: overflow drops)."""
    dropped = _check(pair, _x((3, 40, 32)))
    assert dropped > 0 if pair[0] != "arctic" else dropped == 0


def test_one_token_decode_input_matches_reference(pair):
    """A decode step's shape, (4, 1, D): the capacity clamped to k, nothing
    dropped."""
    assert _check(pair, _x((4, 1, 32), seed=2)) == 0


def test_bf16_matches_reference(pair):
    _check(pair, _x((2, 24, 32), seed=3), tol=TOL_BF16, dtype=torch.bfloat16)


def test_zero_router_ties_go_to_the_lower_expert():
    """Every probability equal: the top k are experts 0 … k−1 in that order,
    and the queue positions follow, as ``lax.top_k``'s."""
    ref_cfg, cfg = _cfgs("deepseek")
    params, _ = unzip(ref_moe.moe_init(jax.random.PRNGKey(0), ref_cfg, jnp.float32))
    params = jax.tree.map(np.asarray, params)
    params["router"] = np.zeros_like(params["router"])
    m = load_reference_params(MoE(cfg, device="cpu"), params)
    x = _x((2, 5, 32), seed=4)
    _check(("ties", ref_cfg, params, m), x)
    routing = m.route(torch.from_numpy(x))
    assert routing.idx.tolist() == [[list(range(6))] * 5] * 2
    assert routing.pos[0].tolist() == [t for t in range(5) for _ in range(6)]


def test_capacity_is_the_reference(pair):
    _, ref_cfg, _, m = pair
    for s in (1, 2, 7, 37, 40, 1000, 2048, 4096):
        assert _capacity(s, m.cfg) == ref_moe._capacity(s, ref_cfg), s


def test_gradient_matches_jax_grad(pair):
    """d(y.sum() + aux) / d(input, every parameter) against ``jax.grad``."""
    _, ref_cfg, params, m = pair
    x = _x((2, 24, 32), seed=5)

    def ref_loss(p, a):
        y, aux = ref_moe.moe_apply(p, a, cfg=ref_cfg)
        return y.sum() + aux

    gp, gx = jax.jit(jax.grad(ref_loss, argnums=(0, 1)))(jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = m(tx)
    names, ps = zip(*m.named_parameters())
    grads = dict(zip(("x",) + names, torch.autograd.grad(y.sum() + aux, (tx,) + ps)))
    want = {"x": gx, **{n: v for n, v in _flat(gp).items()}}
    assert set(grads) == set(want)
    for name, g in grads.items():
        assert _rel(g, want[name]) <= TOL, name


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_init_draws_the_reference_tree():
    """The port's own init: the reference's names, shapes and dtypes (the
    router float32 under bf16 parameters), each at the reference's scale."""
    for case in ("deepseek", "arctic"):
        ref_cfg, cfg = _cfgs(case)
        params, _ = unzip(ref_moe.moe_init(jax.random.PRNGKey(0), ref_cfg, jnp.bfloat16))
        ref = {n: np.asarray(v, np.float32) for n, v in _flat(params).items()}
        got = dict(MoE(cfg, dtype=torch.bfloat16, device="cpu",
                       generator=torch.Generator().manual_seed(0)).named_parameters())
        assert set(got) == set(ref), case
        for name, p in got.items():
            assert tuple(p.shape) == ref[name].shape, name
            assert p.dtype == (torch.float32 if name == "router" else torch.bfloat16), name
            rms, ref_rms = p.float().pow(2).mean().sqrt().item(), np.sqrt((ref[name] ** 2).mean())
            assert abs(rms / ref_rms - 1) < 0.2, (name, rms, ref_rms)


@pytest.mark.parametrize("case", ["deepseek", "arctic"])
def test_moe_block_forward_and_decode_match_reference(case):
    """The ``moe`` kind: norm, global attention, norm, MoE; the forward's aux
    and its KV cache, then every decode step from an empty cache against the
    reference's ``block_decode`` and the block's own full forward."""
    ref_cfg, cfg = _cfgs(case, num_heads=4, num_kv_heads=2)
    params, _ = unzip(ref_blocks.block_init(jax.random.PRNGKey(0), "moe", ref_cfg, jnp.float32))
    params = jax.tree.map(np.asarray, params)
    block = load_reference_params(blocks.Block("moe", cfg, device="cpu"), params)
    assert {n.split(".")[0] for n, _ in block.named_parameters()} == {"norm1", "mixer", "norm2", "moe"}
    s = 12
    x = _x((2, s, 32), seed=6)
    pos = np.broadcast_to(np.arange(s), (2, s))
    yr, cr, aux_r = jax.jit(lambda a, p: ref_blocks.block_forward(params, a, kind="moe", cfg=ref_cfg, positions=p,
                                                                  return_cache=True))(jnp.asarray(x), jnp.asarray(pos))
    with torch.no_grad():
        y, cache, aux = block(torch.from_numpy(x), torch.from_numpy(pos.copy()), return_cache=True)
    assert _rel(y, yr) <= TOL and _rel(aux, aux_r) <= TOL and float(aux) > 0
    assert _rel(cache.k, cr.k) <= TOL and _rel(cache.v, cr.v) <= TOL
    rc = ref_attn.init_kv_cache(ref_cfg, 2, s, window=None, dtype=jnp.float32)
    cache = block.cache_init(2, s, torch.float32)
    step = jax.jit(lambda a, c, t: ref_blocks.block_decode(params, a, c, t, kind="moe", cfg=ref_cfg))
    for t in range(s):
        yr, rc = step(jnp.asarray(x[:, t:t + 1]), rc, jnp.asarray(t, jnp.int32))
        with torch.no_grad():
            yd, cache = block.decode(torch.from_numpy(x[:, t:t + 1]), cache, t)
        assert _rel(yd, yr) <= TOL, t
        assert _rel(yd[:, 0], y[:, t].numpy()) <= TOL, t
