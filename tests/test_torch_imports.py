"""The port and chip_smoke.py never import JAX or the JAX package, and the
port never calls the library FFT."""

import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "src", "repro_torch")

GUARD = """
import sys
sys.path[:0] = [{repo!r}, {src!r}]
import chip_smoke
import repro_torch
import repro_torch.core.fft, repro_torch.kernels.ops, repro_torch.kernels.build
import repro_torch.core.conv, repro_torch.core.overlap, repro_torch.core.tuning
import repro_torch.core.distributed
import repro_torch.analysis.roofline, repro_torch.data
import repro_torch.models.layers.spectral, repro_torch.utils.params
import repro_torch.configs.base, repro_torch.configs.reduce, repro_torch.configs.h2o_danube_1p8b
import repro_torch.models.layers.attention, repro_torch.models.layers.embedding
import repro_torch.models.layers.mlp, repro_torch.models.layers.norms, repro_torch.models.layers.rope
import repro_torch.models.blocks, repro_torch.models.stack, repro_torch.models.model
import repro_torch.serving.sampling, repro_torch.serving.engine, repro_torch.serving.spectral_serve
import repro_torch.launch.serve, repro_torch.launch.train
import repro_torch.configs.gemma3_12b, repro_torch.configs.yi_6b, repro_torch.configs.phi4_mini_3p8b
import repro_torch.data.pipeline, repro_torch.checkpoint.manager, repro_torch.runtime.fault_tolerance
import repro_torch.train.schedule, repro_torch.train.optimizer, repro_torch.train.compression
import repro_torch.train.train_loop
import repro_torch.models.layers.moe, repro_torch.models.layers.ssm, repro_torch.models.layers.xlstm
import repro_torch.configs.zamba2_2p7b, repro_torch.configs.xlstm_125m
import repro_torch.configs.musicgen_large, repro_torch.configs.qwen2_vl_72b
import repro_torch.sharding.logical, repro_torch.sharding.partition, repro_torch.sharding.shard
import repro_torch.launch.mesh, repro_torch.launch.shardings
import repro_torch.configs.fftbench, repro_torch.configs.specs, repro_torch.core.fake
import repro_torch.analysis.trace, repro_torch.analysis.report, repro_torch.analysis.fill_experiments
import repro_torch.launch.dryrun
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print("clean")
"""


def test_port_and_smoke_import_no_jax_and_no_reference():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", GUARD.format(repo=REPO, src=os.path.join(REPO, "src"))],
        capture_output=True, text=True, env=env, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def _py_files():
    for root, _, files in os.walk(PORT):
        for name in files:
            if name.endswith((".py", ".cu", ".cuh")):
                yield os.path.join(root, name)


IMPORT_REF = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)", re.M)


def test_source_scan():
    files = list(_py_files()) + [os.path.join(REPO, "chip_smoke.py")]
    assert len(files) > 10
    for path in files:
        text = open(path, encoding="utf-8").read()
        assert not IMPORT_REF.search(text), path
        assert "jnp." not in text and "jax." not in text, path
        assert not re.search(r"\brepro\.", text), path  # repro_torch. is fine
        if path.startswith(PORT):
            assert "torch.fft" not in text, path
            assert "cufft" not in text.lower(), path
            assert "torch.compile" not in text, path
