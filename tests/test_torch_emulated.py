"""The CUDA sources themselves, compiled for the host and run on the CPU.

The card is the only place the kernels really run, but their index
arithmetic — views, strides, chunking, edge masks, the shared-memory vs
scratch choice — is plain C++.  Here every ``csrc/*.cu`` is compiled with
the host's C++ compiler against ``tests/cuda_emu/cuda_runtime.h`` (blocks run
one at a time, threads as ``std::thread``, ``__syncthreads`` as a barrier),
and each wrapper's launch path (``_launch*``) is driven on CPU tensors
through that library and held against the kernel's plain version.  It
checks no timing, no warp behaviour and nothing of ``nvcc``; the card
tests (``test_torch_cuda.py``) and ``chip_smoke.py`` do.

The shim supports what the sources use now and nothing more: ``__global__``,
``__device__``, ``__host__``, ``__forceinline__``, ``__launch_bounds__``,
static ``__shared__`` arrays, one ``extern __shared__ float2 smem[]``,
``__syncthreads``, ``float2``/``make_float2``, ``threadIdx``/``blockIdx``
on a 1-D grid, ``<<<grid, block, smem, stream>>>`` launches,
``cudaFuncSetAttribute`` for dynamic shared memory and ``cudaGetLastError``.
Warp shuffles and votes, atomics, ``cp.async``/TMA, ``wgmma``/``mma``
intrinsics, thread-block clusters and inline PTX are not in it.  When a
kernel moves past that list, its cases here are retired in favour of its
``cuda``-marked card test, as the kernel's PR says; the shim does not grow
to model the hardware.
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from repro_torch.core import faults, limits
from repro_torch.core import plan as plan_lib
from repro_torch.kernels import build, dft_matmul, fft4step, ops, pencil

SHIM = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda_emu")
TOL = 1e-5  # emulated kernel vs plain: fp32 sums in another order
H100_SMEM = 232448


@pytest.fixture(scope="module")
def emu_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("needs a host C++20 compiler (g++ or clang++)")
    out = tmp_path_factory.mktemp("cuda_emu")
    for src in list(build.csrc_dir().glob("*.cu")) + list(build.csrc_dir().glob("*.cuh")):
        text = src.read_text()
        text = text.replace("extern __shared__ float2 smem[];", "float2* smem = emu_dyn_smem;")
        text = re.sub(r"(\w+)<<<(.+?)>>>\(", r"emu_launch(\1, \2, ", text)
        (out / src.name).write_text(text)
    cus = sorted(out.glob("*.cu"))
    objs = [out / (c.stem + ".o") for c in cus]
    procs = [
        subprocess.Popen(
            [cxx, "-std=c++20", "-O2", "-fPIC", "-pthread", "-I", SHIM, "-x", "c++",
             "-c", str(c), "-o", str(o)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for c, o in zip(cus, objs)
    ]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    lib = out / "libemu.so"
    subprocess.run([cxx, "-shared", "-pthread", "-o", str(lib), *map(str, objs)], check=True)
    handle = ctypes.CDLL(str(lib))
    handle.repro_error_string.argtypes = [ctypes.c_int]
    handle.repro_error_string.restype = ctypes.c_char_p
    return handle


@pytest.fixture
def emulated(emu_lib, monkeypatch):
    """Route the wrappers' launch paths to the emulated library, with the
    H100's shared memory."""
    build.function.cache_clear()
    monkeypatch.setattr(build, "library", lambda: emu_lib)
    monkeypatch.setattr(build, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(limits, "memory_budget", lambda device_kind=None: H100_SMEM)
    yield
    build.function.cache_clear()


#: The four-step kernels run with the H100's shared memory and with a
#: budget small enough to force every intermediate into a scratch slab.
BUDGETS = pytest.mark.parametrize(
    "budget", [H100_SMEM, 20000], ids=["h100-smem", "scratch"], indirect=True
)


@pytest.fixture
def budget(request, emulated, monkeypatch):
    monkeypatch.setattr(limits, "memory_budget", lambda device_kind=None: request.param)
    return request.param


def _planes(seed, *shape):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) for _ in range(2))


def _close(got, want):
    scale = max(want[0].abs().max().item(), want[1].abs().max().item())
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert (a - b).abs().max().item() <= TOL * scale


def _fused(f):
    return ops._fused_luts("cpu", *plan_lib.balanced_split(f), False)


@pytest.mark.parametrize("b,n,epilogue", [(3, 16, False), (5, 2, True), (70, 100, False), (2, 1024, True), (1, 1, False)])
def test_dft_matmul_source(emulated, b, n, epilogue):
    x = _planes(b, b, n)
    w = _planes(n, n, n)
    e = _planes(1, n) if epilogue else (None, None)
    _close(dft_matmul._launch(*x, *w, *e),
           dft_matmul.dft_matmul_plain(*x, *w, twiddle=e if epilogue else None))


@BUDGETS
@pytest.mark.parametrize("b,n,natural,epilogue", [
    (4, 2048, True, False), (3, 2048, False, True), (2, 4096, True, True), (1, 32768, False, False),
])
def test_fft4step_source(budget, b, n, natural, epilogue):
    x = _planes(n, b, n)
    luts = _fused(n)
    e = _planes(2, n) if epilogue else (None, None)
    _close(fft4step._launch(*x, *luts, *e, natural),
           fft4step.fft4step_plain(*x, *luts, natural_order=natural,
                                   twiddle_after=e if epilogue else None))


@BUDGETS
@pytest.mark.parametrize("r,f,s,kind,with_twiddle", [
    (2, 256, 64, "direct", True), (3, 100, 70, "direct", False),
    (2, 2048, 8, "fused4", True), (1, 4096, 16, "fused4", True), (2, 2048, 4, "fused4", False),
])
def test_cols_pass_source(budget, r, f, s, kind, with_twiddle):
    x = _planes(f, r, f, s)
    n1, n2 = (0, 0) if kind == "direct" else plan_lib.balanced_split(f)
    luts = _planes(3, f, f) if kind == "direct" else _fused(f)
    tw = _planes(4, f, s) if with_twiddle else None
    _close(pencil._launch_cols(*x, luts, tw, kind, n1, n2),
           pencil.cols_pass_plain(*x, luts, tw, kind=kind, n1=n1, n2=n2))


@BUDGETS
@pytest.mark.parametrize("b,p,f,kind", [
    (2, 64, 256, "direct"), (3, 70, 100, "direct"), (2, 16, 2048, "fused4"), (1, 8, 4096, "fused4"),
    (2, 4, 2048, "fused4"),
])
def test_rows_natural_source(budget, b, p, f, kind):
    x = _planes(f, b, p, f)
    n1, n2 = (0, 0) if kind == "direct" else plan_lib.balanced_split(f)
    luts = _planes(5, f, f) if kind == "direct" else _fused(f)
    _close(pencil._launch_rows(*x, luts, kind, n1, n2),
           pencil.rows_natural_plain(*x, luts, kind=kind, n1=n1, n2=n2))


def test_refused_launch_raises(emulated):
    """A launch the runtime refuses surfaces as KernelError, not a result."""
    x = _planes(0, 3, 2048)
    luts = _fused(2048)
    with pytest.raises(faults.KernelError, match="launch failed"):
        # lgc = 2 does not divide a batch of 3: the launcher refuses it.
        build.check(build.function("repro_fft4step", fft4step._ARGS)(
            3, 64, 32, 2, 1, *map(build.ptr, (*x, *luts)), None, None,
            *map(build.ptr, x), None, None, 0), "fft4step")
