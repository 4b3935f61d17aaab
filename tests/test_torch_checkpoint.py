"""Checkpointing, the fault-tolerance runtime and the training launcher of the
port on the CPU.

``CheckpointManager``: the reference's layout (``step_XXXXXXXX`` with
``arrays.npz`` and ``manifest.json``), atomic publish, keep-N, async saves,
restore of a whole ``TrainState`` in place; a run stopped and resumed from
its checkpoint equals the uninterrupted run bit for bit (also reduced
zamba2, whose shared block is checkpointed once).  The runtime's
watchdog, retries and straggler statistics; and ``python -m
repro_torch.launch.train`` end to end.
"""

import dataclasses
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import TrainConfig, get_config
from repro_torch.configs.reduce import make_reduced
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.launch import train as train_launch
from repro_torch.models.model import DecoderLM
from repro_torch.runtime.fault_tolerance import StepWatchdog, StragglerStats, with_retries
from repro_torch.train.train_loop import init_train_state, make_train_step
from repro_torch.utils.params import reference_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg():
    cfg = dataclasses.replace(get_config("h2o-danube-1.8b"), use_spectral_mixer=True)
    return dataclasses.replace(make_reduced(cfg), compute_dtype="float32")


def _state(tc, seed=0):
    return init_train_state(_cfg(), tc, device="cpu", generator=torch.Generator().manual_seed(seed))


def _params(state):
    return {n: p.detach().clone() for n, p in state.model.named_parameters()}


def test_save_layout_and_restore_in_place(tmp_path):
    tc = TrainConfig(grad_compression=True)
    st = _state(tc)
    st, _ = make_train_step(_cfg(), tc)(st, make_batch(DataConfig(512, 16, 2), 0))
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(1, st, extra={"data_step": 1})
    files = sorted(os.listdir(tmp_path / "step_00000001"))
    assert files == ["arrays.npz", "manifest.json"]
    manifest = json.load(open(tmp_path / "step_00000001" / "manifest.json"))
    n_params = len(list(st.model.parameters()))
    # step, the parameters, the optimizer's step, m and v, and the residuals
    assert manifest["num_leaves"] == 2 + 3 * n_params + len(st.err_state)
    assert manifest["step"] == 1 and manifest["extra"] == {"data_step": 1}
    saved = _params(st)
    fresh = _state(tc, seed=7)
    assert not all(torch.equal(saved[n], p) for n, p in fresh.model.named_parameters())
    restored, extra = mgr.restore(mgr.latest_step(), fresh)
    assert extra == {"data_step": 1} and restored.step == 1 and restored.opt_state.step == 1
    assert restored.model is fresh.model
    for n, p in restored.model.named_parameters():
        assert torch.equal(p, saved[n]), n
    for k in ("m", "v"):
        for n, t in restored.opt_state.inner[k].items():
            assert torch.equal(t, st.opt_state.inner[k][n])
    for leaf, e in restored.err_state.items():
        assert torch.equal(e, st.err_state[leaf])


def test_restore_refuses_another_architecture(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, _state(TrainConfig()))
    with pytest.raises(ValueError, match="mismatch"):
        mgr.restore(3, _state(TrainConfig(optimizer="sgd")))


def test_atomic_publish_and_keep_n(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    state = {"w": torch.arange(4.0), "n": 3}
    # An unfinished save (its tmp directory, no rename) is never listed.
    os.makedirs(tmp_path / "step_00000009.tmp123_4")
    os.makedirs(tmp_path / "step_00000008")  # no manifest: not complete
    for step in (1, 2, 3):
        mgr.save(step, state)
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    assert not (tmp_path / "step_00000001").exists()
    restored, _ = mgr.restore(3, {"w": torch.zeros(4), "n": 0})
    assert torch.equal(restored["w"], torch.arange(4.0)) and restored["n"] == 3


def test_async_save_is_a_snapshot(tmp_path):
    """An async save copies to the host at once: later updates do not leak
    into it; ``wait`` makes it durable and raises the writer's error."""
    mgr = CheckpointManager(str(tmp_path), keep=3)
    w = torch.ones(1000)
    mgr.save(1, {"w": w}, blocking=False)
    w.add_(1.0)
    mgr.wait()
    restored, _ = mgr.restore(1, {"w": torch.zeros(1000)})
    assert torch.equal(restored["w"], torch.ones(1000))
    with pytest.raises(TypeError, match="cannot checkpoint"):
        mgr.save(2, {"bad": object()}, blocking=False)


def test_stop_and_resume_equals_the_uninterrupted_run(tmp_path):
    """Four steps straight, against two steps, a checkpoint, a fresh state
    restored from it and two more: the same parameters bit for bit."""
    cfg, tc = _cfg(), TrainConfig(total_steps=4, warmup_steps=1, learning_rate=1e-2)
    dcfg = DataConfig(cfg.vocab_size, 16, 2)
    step = make_train_step(cfg, tc)
    straight = _state(tc)
    for i in range(4):
        straight, _ = step(straight, make_batch(dcfg, i))
    run = _state(tc)
    for i in range(2):
        run, _ = step(run, make_batch(dcfg, i))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, run, extra={"data_step": 2}, blocking=False)
    mgr.wait()
    resumed, extra = mgr.restore(mgr.latest_step(), _state(tc, seed=5))
    for i in range(extra["data_step"], 4):
        resumed, _ = step(resumed, make_batch(dcfg, i))
    assert resumed.step == straight.step == 4
    for (n, a), b in zip(resumed.model.named_parameters(), straight.model.parameters()):
        assert torch.equal(a, b), n


def test_launcher_stop_and_resume(tmp_path, capsys):
    """``--stop-at 2`` then a second launch resumes from step 2."""
    args = ["--arch", "h2o-danube-1.8b", "--reduced", "--spectral", "--steps", "4", "--batch", "2",
            "--seq", "16", "--device", "cpu", "--ckpt-dir", str(tmp_path), "--log-every", "1"]
    first = train_launch.main(args + ["--stop-at", "2"])
    second = train_launch.main(args)
    out = capsys.readouterr().out
    assert len(first) == 2 and len(second) == 2
    assert "[resume] restored step 2" in out
    assert CheckpointManager(str(tmp_path)).latest_step() == 4
    assert all(np.isfinite(first + second))


def test_reference_leaves_file_the_shared_block_once():
    """zamba2's shared attention block is one unstacked reference leaf per
    parameter, ``stack.shared.<name>``, not a stacked ``stack.unit.b6``;
    the Mamba2 layers stack over the repeats as every other layer."""
    cfg = make_reduced(get_config("zamba2-2.7b"))
    model = DecoderLM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    leaves = reference_leaves(model)
    shared = {n for n, _ in model.named_parameters() if n.startswith("stack.shared.")}
    assert shared and all(leaves[n] == (False, (n,)) for n in shared)
    assert not any(k.startswith("stack.unit.b6.") for k in leaves)
    assert leaves["stack.unit.b0.mixer.w_in"] == (True, ("stack.0.mixer.w_in", "stack.7.mixer.w_in"))
    assert sum(len(names) for _, names in leaves.values()) == len(list(model.parameters()))


def test_zamba2_checkpoint_keeps_one_copy_of_the_shared_block(tmp_path):
    """Reduced zamba2 through the launcher (AdamW): a run stopped after 2
    steps and resumed gives the straight run's losses; its checkpoint holds
    each shared parameter, its m and its v once."""
    args = ["--arch", "zamba2-2.7b", "--reduced", "--steps", "4", "--batch", "2", "--seq", "16",
            "--device", "cpu", "--log-every", "1"]
    straight = train_launch.main(args)
    first = train_launch.main(args + ["--ckpt-dir", str(tmp_path), "--stop-at", "2"])
    manifest = json.load(open(tmp_path / "step_00000002" / "manifest.json"))
    names = manifest["names"]
    shared = [n for n in names if ".stack.shared." in n]
    n_shared = len(list(DecoderLM(make_reduced(get_config("zamba2-2.7b")), device="meta").stack.shared.parameters()))
    assert len(shared) == len(set(shared)) == 3 * n_shared
    assert not any(f".stack.{i}." in n for n in names for i in (6, 13))
    second = train_launch.main(args + ["--ckpt-dir", str(tmp_path)])
    assert first + second == straight


def test_launcher_refuses_a_mesh():
    # A sharded mesh needs its ranks: none here (no group, no torchrun).
    with pytest.raises(ValueError, match="--mesh 2x1 needs 2 ranks"):
        train_launch.main(["--arch", "h2o-danube-1.8b", "--reduced", "--mesh", "2x1", "--device", "cpu"])


def test_launcher_runs_as_a_module():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "h2o-danube-1.8b", "--reduced",
         "--steps", "3", "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=300, cwd=REPO,
    )
    assert out.returncode == 0, out.stderr
    assert "final:" in out.stdout and "step     2" in out.stdout


# ---------------------------------------------------------------------------
# the runtime
# ---------------------------------------------------------------------------


def test_watchdog_fires_on_a_hang_and_not_otherwise():
    fired = threading.Event()
    wd = StepWatchdog(0.2, fired.set)
    try:
        wd.arm()
        wd.disarm()
        time.sleep(0.4)
        assert not wd.fired
        wd.arm()
        assert fired.wait(timeout=5.0)
        assert wd.fired
    finally:
        wd.close()


def test_with_retries_retries_transient_errors():
    calls, seen = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise RuntimeError("transient device error")
        return "ok"

    assert with_retries(flaky, retries=3, backoff_s=0.0, on_retry=lambda a, e: seen.append(a)) == "ok"
    assert len(calls) == 3 and seen == [0, 1]
    with pytest.raises(OSError):
        with_retries(lambda: (_ for _ in ()).throw(OSError("disk")), retries=1, backoff_s=0.0)
    with pytest.raises(ValueError):  # not a transient error: no retry
        with_retries(lambda: (_ for _ in ()).throw(ValueError("bug")), retries=3, backoff_s=0.0)


def test_straggler_stats():
    s = StragglerStats(alpha=0.5, threshold=2.0)
    assert s.record(1.0) is False
    assert s.record(1.0) is False
    assert s.record(3.0) is True  # > 2 · ewma
    assert s.record(100.0) is True  # an outlier past 4 · ewma leaves the mean alone
    assert s.summary() == {"ewma_s": 2.0, "stragglers": 2, "steps": 4}
