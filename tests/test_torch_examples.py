"""The four examples of the port on the CPU (``--device cpu``).

The SAR scenes' functions at the reference example's sizes are held
against the reference's own pipeline on the same data (its
``fft_conv2d``, ``axis=-2`` plan, ``fft2`` plan and ``fft_conv(pad=
"exact")``) at 1e-3·max|ref|, every target found; quickstart, serve_decode
and train_lm run as subprocesses (started together) and exit 0.
"""

import importlib.util
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import fft as ref_fft
from repro.core.conv import fft_conv as ref_fft_conv
from repro.core.conv import fft_conv2d as ref_fft_conv2d

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-3


def load_example(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


sar = load_example("sar_imaging_torch")


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def test_stripmap_matches_reference():
    n_az, n_rg, chirp_len = sar.STRIPMAP
    image, raw, matched, targets = sar.stripmap(n_az, n_rg, chirp_len, device="cpu")
    assert targets == sar.STRIPMAP_TARGETS
    rc = ref_fft_conv2d(jnp.asarray(raw.numpy()), jnp.asarray(matched.numpy())[None, :], mode="same")
    ar, ai = ref_fft.plan(ref_fft.FFTSpec(n=n_az, kind="fft", axis=-2)).apply_planes(rc, jnp.zeros_like(rc))
    assert _rel(image.numpy(), np.hypot(np.asarray(ar), np.asarray(ai))) <= TOL
    assert all(hit[0] for hit in sar.stripmap_found(image, targets, chirp_len))


def test_spotlight_matches_reference():
    n_az, n_rg = sar.SPOTLIGHT
    image, ph, targets = sar.spotlight(n_az, n_rg, device="cpu")
    assert targets == sar.SPOTLIGHT_TARGETS
    ref = ref_fft.plan(ref_fft.FFTSpec(n=n_rg, kind="fft2", n2=n_az))(jnp.asarray(ph.numpy()))
    assert _rel(image.numpy(), np.abs(np.asarray(ref)) / (n_az * n_rg)) <= TOL
    assert all(hit[0] for hit in sar.spotlight_found(image, targets))


def test_prime_range_line_matches_reference():
    n_rg, chirp_len = sar.RANGE_LINE
    image, line, pulse = sar.range_lines(n_rg, chirp_len, device="cpu")
    assert image.shape == (len(sar.RANGE_OFFSETS), n_rg)
    ref = ref_fft_conv(jnp.asarray(line.numpy()), jnp.asarray(pulse.numpy()[::-1].copy()), pad="exact")
    assert _rel(image.numpy(), np.abs(np.asarray(ref))) <= TOL
    assert all(hit[0] for hit in sar.range_found(image, sar.RANGE_OFFSETS, chirp_len))


def test_sar_main_finds_every_target(capsys):
    assert sar.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count(" OK") == 10 and "MISS" not in out
    assert "modeled HBM" in out and "kernels: pass 0 bluestein_fwd" in out


#: The examples run as scripts: their arguments and a line each must print.
RUNS = {
    "quickstart_torch": ([], "check='parseval' and check='nan' pass"),
    "serve_decode_torch": ([], "kv_cache=int8: generated (4, 24)"),
    "train_lm_torch": (["--steps", "3", "--arch", "h2o-danube-1.8b", "--batch", "2", "--seq", "64"],
                       "trained 3 steps"),
}


@pytest.fixture(scope="module")
def example_runs(tmp_path_factory):
    """Start every example at once (each one process, the plain route, one
    intra-op thread: three processes of a thread per core each take four
    times as long)."""
    tmp = tmp_path_factory.mktemp("examples")
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
           "REPRO_TUNING_CACHE": str(tmp / "tuning.json"), "OMP_NUM_THREADS": "1"}
    procs = {}
    for name, (argv, _) in RUNS.items():
        extra = ["--ckpt-dir", str(tmp / "ckpt")] if name == "train_lm_torch" else []
        procs[name] = subprocess.Popen(
            [sys.executable, os.path.join(REPO, "examples", f"{name}.py"), "--device", "cpu", *argv, *extra],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
    runs = {}
    try:
        for name, proc in procs.items():
            out, errs = proc.communicate(timeout=240)
            runs[name] = (proc.returncode, out, errs)
    finally:
        for proc in procs.values():
            proc.kill()
    return runs


@pytest.mark.parametrize("name", sorted(RUNS))
def test_example_runs_on_the_cpu(example_runs, name):
    rc, out, errs = example_runs[name]
    assert rc == 0, errs[-3000:]
    assert RUNS[name][1] in out
    # Every yes/no line the example prints says yes.
    assert ": False" not in out, out
