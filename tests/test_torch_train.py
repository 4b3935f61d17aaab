"""The training path (``repro_torch.train``, ``models.model.loss_fn``,
``data.pipeline``) against the reference on the CPU.

The reference's ``TrainState`` (``init_train_state`` at ``PRNGKey(0)``,
then its own jitted ``make_train_step``) is carried into the port by
``load_reference_train_state``; the same ``make_batch`` batches go through
both, at float32 compute on reduced configs (``make_reduced``: h2o-danube
dense and with ``use_spectral_mixer``, gemma3-12b, and deepseek-moe-16b,
whose loss carries the MoE layers' aux term).  Tolerances: loss
and metrics 1e-5 relative; each parameter's gradient 1e-4·max|ref|; a
parameter update Δp 1e-5·max|Δp_ref| (SGD, Adafactor) — except AdamW's,
1e-3·max|Δp_ref|: Adam's update is m̂/(√v̂ + eps), at step 1 exactly
g/(|g| + eps), which turns a gradient's last-ulp differences into large
ones wherever |g| is near 0 (the second step, 1.2e-5 at one element here);
at step 1 each element is also allowed the first-order bound of that
amplification from the two sides' gradients (an element with |g| ≈ eps
moves by ~1e-3 of the update for a 1e-10 difference in g).  Every Δp is also allowed one float32 spacing of the
parameter, to which each side rounds p + Δp.  One jit per config and
optimizer (cached per module).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.configs.reduce import make_reduced as ref_make_reduced
from repro.data import pipeline as ref_pipeline
from repro.models import model as ref_model
from repro.train import compression as ref_comp
from repro.train import optimizer as ref_opt
from repro.train import schedule as ref_schedule
from repro.train import train_loop as ref_loop
from repro_torch.configs import base
from repro_torch.configs.reduce import make_reduced
from repro_torch.data import pipeline
from repro_torch.models import model as model_lib
from repro_torch.models.stack import find_unit
from repro_torch.train import compression, optimizer, schedule, train_loop
from repro_torch.utils.params import load_reference_model, load_reference_train_state, reference_leaves

MET_TOL = 1e-5
GRAD_TOL = 1e-4
STEP_TOL = 1e-5
ADAM_TOL = 1e-3
B, S = 4, 24  # S = one 16-position loss chunk and a remainder of 8


@pytest.fixture(autouse=True)
def _reference_untuned(monkeypatch):
    monkeypatch.setenv("REPRO_FFT_TUNE", "off")


CONFIGS = {
    "dense": ("h2o-danube-1.8b", False),
    "spectral": ("h2o-danube-1.8b", True),
    "gemma3": ("gemma3-12b", False),
    "moe": ("deepseek-moe-16b", False),
}


@functools.lru_cache(maxsize=None)
def _cfgs(which):
    arch, spectral = CONFIGS[which]
    ref = ref_make_reduced(dataclasses.replace(ref_base.get_config(arch), use_spectral_mixer=spectral))
    port = make_reduced(dataclasses.replace(base.get_config(arch), use_spectral_mixer=spectral))
    ref, port = (dataclasses.replace(c, compute_dtype="float32") for c in (ref, port))
    assert dataclasses.asdict(ref) == dataclasses.asdict(port)
    return ref, port


def _batch(cfg, step=0, b=B, s=S):
    return ref_pipeline.make_batch(ref_pipeline.DataConfig(cfg.vocab_size, s, b), step)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(got, ref):
    got = got.detach().double().numpy() if torch.is_tensor(got) else np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _per_param(model, tree):
    """The reference's parameter-shaped tree, unstacked to the port's names."""
    return _per_param_np(model.cfg, tree)


def _per_param_np(cfg, tree):
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


@functools.lru_cache(maxsize=None)
def _reference_run(which, opt="adamw", micro=1, comp=False):
    """The reference's state at step 0, 1 and 2 (numpy) and the metrics of
    its two steps on batches 0 and 1."""
    ref_cfg, _ = _cfgs(which)
    tc = ref_base.TrainConfig(optimizer=opt, microbatches=micro, grad_compression=comp,
                              warmup_steps=2, total_steps=10, learning_rate=1e-2)
    step = jax.jit(ref_loop.make_train_step(ref_cfg, tc))
    states, metrics = [ref_loop.init_train_state(jax.random.PRNGKey(0), ref_cfg, tc)], []
    for i in range(2):
        s, m = step(states[-1], {k: jnp.asarray(v) for k, v in _batch(ref_cfg, i).items()})
        states.append(s)
        metrics.append(_np(m))
    return tc, [_np(s) for s in states], metrics


def _port_state(which, tc, ref_state):
    _, cfg = _cfgs(which)
    port_tc = base.TrainConfig(**dataclasses.asdict(tc))
    st = train_loop.init_train_state(cfg, port_tc, device="cpu", generator=torch.Generator().manual_seed(1))
    return port_tc, load_reference_train_state(st, ref_state)


def _check_metrics(got, ref):
    assert set(got) == set(ref)
    for k in ref:
        assert _rel(torch.as_tensor(got[k]), ref[k]) <= MET_TOL, k


def _check_update(model, before, after, tol, allowance=None):
    """Each parameter's update Δp against the reference's, elementwise within
    ``tol``·max|Δp_ref| of its tensor, plus one float32 spacing of the new
    value (each side rounds p + Δp to float32 on its own) and, where given,
    ``allowance[name]``."""
    b, a = _per_param(model, before.params), _per_param(model, after.params)
    for name, p in model.named_parameters():
        got = p.detach().numpy().astype(np.float64) - b[name]
        want = a[name].astype(np.float64) - b[name]
        slack = tol * np.abs(want).max() + np.spacing(np.maximum(np.abs(a[name]), np.abs(b[name])))
        if allowance is not None:
            slack = slack + allowance[name]
        assert (np.abs(got - want) <= slack).all(), (name, np.abs(got - want).max() / np.abs(want).max())


def _adam_first_allowance(which, tc, state):
    """lr·|f(g_port) − f(g_ref)| bounded to first order, f(g) = g/(|g| + eps),
    per element: Adam's first update is f of the clipped gradient, whose
    slope eps/(|g| + eps)² reaches 1/eps at g = 0.  Where the two clipped
    gradients have one sign the bound is eps·|Δg|/(min|g| + eps)², else
    |Δg|/eps."""
    ref_cfg, cfg = _cfgs(which)
    batch = _batch(ref_cfg, 0)
    ref_g = jax.jit(jax.grad(lambda p: ref_model.loss_fn(p, batch, ref_cfg, tc)[0]))(jax.tree.map(jnp.asarray, state.params))
    ref_g = _per_param_np(cfg, _np(ref_opt.clip_by_global_norm(ref_g, tc.grad_clip)[0]))
    model = load_reference_model(model_lib.DecoderLM(cfg, device="cpu"), state.params)
    loss, _ = model_lib.loss_fn(model, {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}, tc)
    names, ps = zip(*model.named_parameters())
    got_g, _ = optimizer.clip_by_global_norm(dict(zip(names, torch.autograd.grad(loss, ps))), tc.grad_clip)
    eps, out = 1e-8, {}
    for name in names:
        a, r = got_g[name].numpy().astype(np.float64), ref_g[name].astype(np.float64)
        m = np.where(np.sign(a) == np.sign(r), np.minimum(np.abs(a), np.abs(r)), 0.0)
        out[name] = tc.learning_rate * 1.01 * eps * np.abs(a - r) / (m + eps) ** 2
    return out


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _reference_loss(which):
    ref_cfg, _ = _cfgs(which)
    params, _ = ref_model.init_unzipped(jax.random.PRNGKey(0), ref_cfg)
    batch = {k: jnp.asarray(v) for k, v in _batch(ref_cfg).items()}
    batch["loss_mask"] = batch["loss_mask"].at[0, :5].set(0.0)
    (_, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: ref_model.loss_fn(p, batch, ref_cfg, ref_base.TrainConfig()), has_aux=True))(params)
    return _np(params), _np(batch), _np(metrics), _np(grads)


@pytest.mark.parametrize("which", list(CONFIGS))
def test_loss_fn_and_gradients_match_reference(which):
    """``loss_fn``'s loss, ce, aux and token count (with a masked span), and
    every parameter's gradient."""
    _, cfg = _cfgs(which)
    params, batch, ref_metrics, ref_grads = _reference_loss(which)
    model = load_reference_model(model_lib.DecoderLM(cfg, device="cpu"), params)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    loss, metrics = model_lib.loss_fn(model, tb, base.TrainConfig())
    _check_metrics({k: v.detach() for k, v in metrics.items()}, ref_metrics)
    names, ps = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, ps)))
    want = _per_param(model, ref_grads)
    assert set(want) == set(grads)
    for name, g in grads.items():
        assert _rel(g, want[name]) <= GRAD_TOL, name


def test_loss_without_mask_and_remat_off():
    """No ``loss_mask`` is a mask of ones; ``remat=False`` gives the same
    loss and gradients as the checkpointed blocks."""
    _, cfg = _cfgs("spectral")
    params, batch, _, _ = _reference_loss("spectral")
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items() if k != "loss_mask"}
    out = []
    for remat in (True, False):
        model = load_reference_model(model_lib.DecoderLM(dataclasses.replace(cfg, remat=remat), device="cpu"),
                                     params)
        loss, metrics = model_lib.loss_fn(model, tb)
        assert float(metrics["tokens"]) == B * S
        out.append((loss.detach(), torch.autograd.grad(loss, list(model.parameters()))))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.allclose(a, b, rtol=0, atol=1e-6 * float(b.abs().max()))


# ---------------------------------------------------------------------------
# one step per optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("opt", ["adamw", "adafactor", "sgd"])
def test_train_step_matches_reference(opt):
    """From the reference's step-0 state and from its step-1 state (m, v or
    the factored statistics, and the step counters, carried over), one port
    step each against the reference's next step."""
    tc, states, metrics = _reference_run("spectral", opt)
    _, cfg = _cfgs("spectral")
    for i in range(2):
        port_tc, st = _port_state("spectral", tc, states[i])
        assert st.step == i and st.opt_state.step == i
        st, got = train_loop.make_train_step(cfg, port_tc)(st, pipeline.make_batch(
            pipeline.DataConfig(cfg.vocab_size, S, B), i))
        assert st.step == st.opt_state.step == i + 1
        _check_metrics(got, metrics[i])
        if opt != "adamw":
            _check_update(st.model, states[i], states[i + 1], STEP_TOL)
        elif i == 0:
            _check_update(st.model, states[i], states[i + 1], ADAM_TOL,
                          _adam_first_allowance("spectral", port_tc, states[i]))
        else:
            _check_update(st.model, states[i], states[i + 1], ADAM_TOL)


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_moe_step_matches_reference(opt):
    """The reduced deepseek-moe-16b (``moe`` × 2, 8 experts, top-2, one
    shared): loss and aux, and one step from the reference's step-0 state
    and one from its step-1 state, against the reference's (Adafactor's
    factored statistics of the expert weights span the (R, E, D, F) leaf)."""
    tc, states, metrics = _reference_run("moe", opt)
    _, cfg = _cfgs("moe")
    assert all(float(m["aux"]) > 0 for m in metrics)
    for i in range(2):
        port_tc, st = _port_state("moe", tc, states[i])
        st, got = train_loop.make_train_step(cfg, port_tc)(st, pipeline.make_batch(
            pipeline.DataConfig(cfg.vocab_size, S, B), i))
        _check_metrics(got, metrics[i])
        if opt == "adafactor":
            _check_update(st.model, states[i], states[i + 1], STEP_TOL)
        else:
            allowance = _adam_first_allowance("moe", port_tc, states[i]) if i == 0 else None
            _check_update(st.model, states[i], states[i + 1], ADAM_TOL, allowance)


def test_microbatches_match_reference():
    """microbatches=2: the gradient is the mean of the two halves' and the
    metrics are the last microbatch's, as the reference's scan carries
    them."""
    tc, states, metrics = _reference_run("spectral", "sgd", micro=2)
    _, cfg = _cfgs("spectral")
    port_tc, st = _port_state("spectral", tc, states[0])
    st, got = train_loop.make_train_step(cfg, port_tc)(st, pipeline.make_batch(
        pipeline.DataConfig(cfg.vocab_size, S, B), 0))
    _check_metrics(got, metrics[0])
    assert float(got["tokens"]) == float(_batch(cfg)["loss_mask"][B // 2:].sum())
    _check_update(st.model, states[0], states[1], STEP_TOL)


def test_compressed_step_matches_reference():
    """grad_compression: two steps with the error state carried (the
    second from the reference's residuals); int8 rounding may flip where
    the two gradients straddle a rounding boundary, so the residuals are
    held to one quantum (amax/127) of their leaf."""
    tc, states, metrics = _reference_run("spectral", "sgd", comp=True)
    _, cfg = _cfgs("spectral")
    for i in range(2):
        port_tc, st = _port_state("spectral", tc, states[i])
        st, got = train_loop.make_train_step(cfg, port_tc)(st, pipeline.make_batch(
            pipeline.DataConfig(cfg.vocab_size, S, B), i))
        _check_metrics(got, metrics[i])
        ref_err = _flat(states[i + 1].err_state)
        assert set(ref_err) == set(st.err_state)
        for leaf, e in st.err_state.items():
            quantum = np.abs(ref_err[leaf]).max() * 2 + 1e-30  # the residual is within ±quantum/2
            assert np.abs(e.numpy() - ref_err[leaf]).max() <= 1.01 * quantum, leaf


def test_compress_grads_is_the_reference_on_the_same_gradients():
    """On identical gradients the int8 round trip and the residual are the
    reference's bit for bit, over two rounds of error feedback."""
    _, cfg = _cfgs("spectral")
    model = model_lib.DecoderLM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    leaves = reference_leaves(model)
    rng = np.random.default_rng(0)
    err = compression.init_error_state(model)
    ref_err = {leaf: np.zeros(e.shape, np.float32) for leaf, e in err.items()}
    for _ in range(2):
        g = {leaf: rng.standard_normal(e.shape).astype(np.float32) for leaf, e in err.items()}
        ref_out, ref_err = ref_comp.compress_grads({k: jnp.asarray(v) for k, v in g.items()},
                                                   {k: jnp.asarray(v) for k, v in ref_err.items()})
        per = {}
        for leaf, (stacked, names) in leaves.items():
            for i, name in enumerate(names):
                per[name] = torch.from_numpy(g[leaf][i] if stacked else g[leaf])
        out, err = compression.compress_grads(per, err, model)
        for leaf, (stacked, names) in leaves.items():
            got = torch.stack([out[n] for n in names]) if stacked else out[names[0]]
            assert np.array_equal(got.numpy(), np.asarray(ref_out[leaf])), leaf
            assert np.array_equal(err[leaf].numpy(), np.asarray(ref_err[leaf])), leaf
        ref_err = _np(ref_err)


def test_global_norm_and_clip_match_reference():
    rng = np.random.default_rng(3)
    grads = {f"g{i}": rng.standard_normal(s).astype(np.float32) for i, s in enumerate([(3, 4), (5,), (2, 2, 2)])}
    for max_norm in (0.5, 100.0):
        ref, ref_norm = ref_opt.clip_by_global_norm({k: jnp.asarray(v) for k, v in grads.items()}, max_norm)
        got, norm = optimizer.clip_by_global_norm({k: torch.from_numpy(v) for k, v in grads.items()}, max_norm)
        assert _rel(norm, ref_norm) <= MET_TOL
        for k in grads:
            assert got[k].dtype == torch.float32 and _rel(got[k], ref[k]) <= MET_TOL


def test_schedule_matches_reference():
    for tc in (base.TrainConfig(), base.TrainConfig(warmup_steps=0, total_steps=5, learning_rate=1e-2)):
        ref = ref_schedule.make_schedule(tc)
        got = schedule.make_schedule(tc)
        for step in (0, 1, 5, 50, 99, 100, 101, 500, 999, 1000, 5000):
            assert abs(got(step) - float(ref(step))) <= 1e-6 * tc.learning_rate, step


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="unknown optimizer"):
        optimizer.make_optimizer(base.TrainConfig(optimizer="lion"))


def test_train_and_parallel_configs_copy_the_reference():
    assert dataclasses.asdict(base.TrainConfig()) == dataclasses.asdict(ref_base.TrainConfig())
    assert dataclasses.asdict(base.ParallelConfig()) == dataclasses.asdict(ref_base.ParallelConfig())


def test_load_reference_train_state_refuses_mismatches():
    tc, states, _ = _reference_run("spectral", "adamw")
    _, st = _port_state("spectral", tc, states[1])
    bad = states[1]._replace(opt_state=states[1].opt_state._replace(
        inner={"m": states[1].opt_state.inner["m"], "v": {"embed": states[1].opt_state.inner["v"]["embed"]}}))
    with pytest.raises(KeyError, match="names differ"):
        load_reference_train_state(st, bad)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,step,b,s", [(0, 0, 4, 24), (0, 7, 2, 513), (3, 1, 8, 64)])
def test_make_batch_is_the_reference_bit_for_bit(seed, step, b, s):
    dcfg = dict(vocab_size=512, seq_len=s, global_batch=b, seed=seed)
    ref = ref_pipeline.make_batch(ref_pipeline.DataConfig(**dcfg), step)
    got = pipeline.make_batch(pipeline.DataConfig(**dcfg), step)
    assert set(got) == set(ref)
    assert got["tokens"].dtype == got["targets"].dtype == torch.int64
    assert got["loss_mask"].dtype == torch.float32
    for k in ref:
        assert np.array_equal(got[k].numpy(), ref[k]) and got[k].shape == ref[k].shape, k
    halves = [pipeline.host_batch_slice(got, i, 2) for i in range(2)]
    ref_halves = [ref_pipeline.host_batch_slice(ref, i, 2) for i in range(2)]
    for h, rh in zip(halves, ref_halves):
        assert all(np.array_equal(h[k].numpy(), rh[k]) for k in rh)


def test_synthetic_lm_state_and_restore():
    dcfg = pipeline.DataConfig(vocab_size=512, seq_len=16, global_batch=2, seed=5)
    it = pipeline.SyntheticLM(dcfg)
    first = [next(it) for _ in range(3)]
    again = pipeline.SyntheticLM.restore(dcfg, {"step": 1, "seed": 5})
    assert it.state() == {"step": 3, "seed": 5}
    assert torch.equal(next(again)["tokens"], first[1]["tokens"])
    with pytest.raises(ValueError, match="seed mismatch"):
        pipeline.SyntheticLM.restore(dcfg, {"step": 0, "seed": 4})
