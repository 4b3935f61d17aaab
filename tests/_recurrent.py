"""Helpers shared by the recurrent-block tests (``test_torch_ssm.py``,
``test_torch_xlstm.py``) and the frontend tests (``test_torch_frontends.py``,
whose batches ``check_training`` takes through ``batch_of``): the same
configuration as the reference's and as
the port's, the reference's parameters loaded into the port, and the
whole-model checks (logits, prefill and decode, loss, gradients and one
AdamW step) at float32 compute.  Every tolerance is relative to max|ref|.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import base as ref_base
from repro.configs.reduce import make_reduced as ref_make_reduced
from repro.data import pipeline as ref_pipeline
from repro.models import model as ref_model
from repro.train import train_loop as ref_loop
from repro_torch.configs import base
from repro_torch.configs.reduce import make_reduced
from repro_torch.models import model as model_lib
from repro_torch.models.stack import find_unit
from repro_torch.train import train_loop
from repro_torch.utils.params import load_reference_model, load_reference_train_state

LOGITS_TOL = 1e-4  # whole-model logits and gradients against the reference
DECODE_TOL = 1e-3  # prefill + decode against the full forward
ADAM_TOL = 1e-3  # an AdamW update Δp against the reference's (tests/test_torch_train.py)


def rel(got, ref) -> float:
    got = got.detach().double().numpy() if torch.is_tensor(got) else np.asarray(got, np.float64)
    ref = np.asarray(jnp.asarray(ref, jnp.float32), np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def randn(shape, seed=1, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def port_cfg(ref_cfg):
    """The port's ``ModelConfig`` with every field of the reference's."""
    cfg = base.ModelConfig(**dataclasses.asdict(ref_cfg))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    return cfg


def reduced(arch, units=2, **changes):
    """``make_reduced`` of a registered config (``units`` repeats of its
    pattern's unit), the reference's and the port's, at float32 compute."""
    changes = {"compute_dtype": "float32", **changes}
    ref_cfg = dataclasses.replace(ref_make_reduced(ref_base.get_config(arch), units=units), **changes)
    cfg = dataclasses.replace(make_reduced(base.get_config(arch), units=units), **changes)
    assert dataclasses.asdict(ref_cfg) == dataclasses.asdict(cfg)
    return ref_cfg, cfg


def model_pair(ref_cfg, cfg):
    """The reference's ``init_unzipped`` at ``PRNGKey(0)`` (numpy) and the
    port's ``DecoderLM`` holding the same values."""
    params = np_tree(ref_model.init_unzipped(jax.random.PRNGKey(0), ref_cfg)[0])
    return params, load_reference_model(model_lib.DecoderLM(cfg, device="cpu"), params)


def check_model(ref_cfg, params, model, b, s, sp):
    """Logits over (b, s) tokens against the reference's (LOGITS_TOL); the
    prefill of the first ``sp`` (its logits, and each layer's decode state
    against the reference's), then every decode step to s against the
    port's own forward (DECODE_TOL)."""
    toks = np.random.default_rng(s).integers(0, ref_cfg.vocab_size, (b, s))
    ref = jax.jit(lambda p, t: ref_model.logits_fn(p, {"tokens": t}, ref_cfg)[0])(params, jnp.asarray(toks))
    with torch.no_grad():
        full = model.logits_fn(torch.from_numpy(toks))
    assert rel(full, ref) <= LOGITS_TOL
    lp, caches = model.prefill(torch.from_numpy(toks[:, :sp]))
    caches = model.prepare_decode_caches(caches, s)
    assert rel(lp, full[:, sp - 1].numpy()) <= DECODE_TOL
    rlp, rc = jax.jit(lambda p, t: ref_model.prefill(p, {"tokens": t}, ref_cfg))(params, jnp.asarray(toks[:, :sp]))
    rc = ref_model.prepare_decode_caches(rc, ref_cfg, sp, s)
    assert rel(lp, rlp) <= LOGITS_TOL
    unit = find_unit(ref_cfg.pattern())
    for layer, c in enumerate(caches):
        ref_c = jax.tree.map(lambda a, r=layer // len(unit): a[r], rc[layer % len(unit)])
        assert type(c).__name__ == type(ref_c).__name__, layer
        for name, a in c._asdict().items():
            if torch.is_tensor(a):
                assert rel(a.float(), getattr(ref_c, name)) <= LOGITS_TOL, (layer, name)
    for t in range(sp, s):
        got, caches = model.decode_step(torch.from_numpy(toks[:, t]), caches, t)
        assert rel(got, full[:, t].numpy()) <= DECODE_TOL, t


def token_batch(cfg, step, b, s):
    """``make_batch``'s tokens, targets and loss mask (numpy)."""
    return ref_pipeline.make_batch(ref_pipeline.DataConfig(cfg.vocab_size, s, b), step)


def _per_param(cfg, tree):
    """A reference parameter-shaped tree unstacked to the port's names (the
    shared block's ``stack.shared.*`` as it is)."""
    width = len(find_unit(cfg.pattern()))
    out = {}
    for name, v in _flat(tree).items():
        if name.startswith("stack.unit.b"):
            pos, _, rest = name[len("stack.unit.b"):].partition(".")
            for r in range(v.shape[0]):
                out[f"stack.{r * width + int(pos)}.{rest}"] = v[r]
        else:
            out[name] = v
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def port_grads(model, batch):
    """``loss_fn``'s loss and metrics and every parameter's gradient."""
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    loss, metrics = model_lib.loss_fn(model, tb, base.TrainConfig())
    names, ps = zip(*model.named_parameters())
    return loss, metrics, dict(zip(names, torch.autograd.grad(loss, ps)))


def check_training(ref_cfg, cfg, b=3, s=16, batch_of=token_batch):
    """Two AdamW steps of the reference's jitted ``make_train_step`` from
    its ``init_train_state``, on ``batch_of(cfg, step, b, s)`` (numpy); the
    port takes each from the reference's state before it
    (``load_reference_train_state``).  Per step: the
    metrics (loss, ce, aux, tokens, the gradient's norm, lr) within 1e-5;
    m and v within LOGITS_TOL — m is (1 − b1)·g + b1·m_before, so this holds
    every clipped gradient against the reference's ``jax.grad``; each Δp
    within ADAM_TOL·max|Δp_ref| plus one float32 spacing plus the
    first-order effect of the two sides' difference in m on m̂/(√v̂ + eps),
    which is large only where a gradient is rounding noise (|g| ≪ eps: the
    sLSTM's input-gate bias, whose every effect the stabiliser cancels), as
    ``tests/test_torch_train.py`` allows at Adam's first step."""
    tc = ref_base.TrainConfig(warmup_steps=2, total_steps=10, learning_rate=1e-2)
    step = jax.jit(ref_loop.make_train_step(ref_cfg, tc))
    states, ref_metrics = [np_tree(ref_loop.init_train_state(jax.random.PRNGKey(0), ref_cfg, tc))], []
    for i in range(2):
        batch = {k: jnp.asarray(v) for k, v in batch_of(ref_cfg, i, b, s).items()}
        st, m = step(jax.tree.map(jnp.asarray, states[-1]), batch)
        states.append(np_tree(st))
        ref_metrics.append(np_tree(m))
    port_tc = base.TrainConfig(**dataclasses.asdict(tc))
    port_step = train_loop.make_train_step(cfg, port_tc)
    for i in range(2):
        before, after = states[i], states[i + 1]
        st = train_loop.init_train_state(cfg, port_tc, device="cpu", generator=torch.Generator().manual_seed(1))
        st = load_reference_train_state(st, before)
        st, metrics = port_step(st, {k: np.asarray(v) for k, v in batch_of(cfg, i, b, s).items()})
        assert set(metrics) == set(ref_metrics[i])
        for k, v in ref_metrics[i].items():
            assert rel(torch.as_tensor(metrics[k]), v) <= 1e-5, (i, k)
        p0, p1 = _per_param(cfg, before.params), _per_param(cfg, after.params)
        m1, v1 = (_per_param(cfg, after.opt_state.inner[k]) for k in ("m", "v"))
        bc1, bc2 = 1 - tc.b1 ** (i + 1), 1 - tc.b2 ** (i + 1)
        for name, p in st.model.named_parameters():
            m, v = st.opt_state.inner["m"][name], st.opt_state.inner["v"][name]
            assert rel(m, m1[name]) <= LOGITS_TOL and rel(v, v1[name]) <= LOGITS_TOL, (i, name)
            got = p.detach().numpy().astype(np.float64) - p0[name]
            want = p1[name].astype(np.float64) - p0[name]
            slack = (ADAM_TOL * np.abs(want).max() + np.spacing(np.maximum(np.abs(p1[name]), np.abs(p0[name])))
                     + 1.01 * float(metrics["lr"]) * np.abs(m.numpy() - m1[name]) / bc1
                     / (np.sqrt(v1[name] / bc2) + 1e-8))
            assert (np.abs(got - want) <= slack).all(), (i, name)
