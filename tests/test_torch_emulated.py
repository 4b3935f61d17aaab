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

import contextlib
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


class DeviceLog(list):
    """Stands in for ``torch.cuda.device`` (which takes CUDA devices only):
    records the device each launch enters."""

    def __call__(self, device):
        self.append(device)
        return contextlib.nullcontext()


@pytest.fixture
def emulated(emu_lib, monkeypatch):
    """Route the wrappers' launch paths to the emulated library, with the
    H100's shared memory; yields the log of devices the launches entered."""
    build.function.cache_clear()
    log = DeviceLog()
    monkeypatch.setattr(build, "library", lambda: emu_lib)
    monkeypatch.setattr(build, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(limits, "memory_budget", lambda device_kind=None: H100_SMEM)
    monkeypatch.setattr(torch.cuda, "device", log)
    yield log
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


@BUDGETS
@pytest.mark.parametrize("r,f,s,kind,tw_every", [
    (2, 256, 32, "direct", 8), (1, 100, 12, "direct", 4),
    (2, 2048, 32, "fused4", 16), (1, 4096, 16, "fused4", 4), (1, 2048, 8, "fused4", 2),
])
def test_cols_pass_tw_every_source(budget, r, f, s, kind, tw_every):
    """The width-broadcast twiddle of a strip-mined column factor; chunks
    never straddle two twiddle columns (tw_every < 8 cuts the chunk)."""
    x = _planes(f, r, f, s)
    n1, n2 = (0, 0) if kind == "direct" else plan_lib.balanced_split(f)
    luts = _planes(3, f, f) if kind == "direct" else _fused(f)
    tw = _planes(4, f, s // tw_every)
    _close(pencil._launch_cols(*x, luts, tw, kind, n1, n2, tw_every),
           pencil.cols_pass_plain(*x, luts, tw, kind=kind, n1=n1, n2=n2, tw_every=tw_every))


@BUDGETS
@pytest.mark.parametrize("r,f,s,with_twiddle", [
    (1, 2048, 13, True), (2, 2048, 3, False), (1, 4096, 9, True), (2, 2048, 1, True),
])
def test_cols_pass_ragged_width_source(budget, r, f, s, with_twiddle):
    """An odd width in the fused column kernel: the last chunk is masked,
    and nothing past the width is read or written."""
    x = _planes(f, r, f, s)
    n1, n2 = plan_lib.balanced_split(f)
    luts = _fused(f)
    tw = _planes(4, f, s) if with_twiddle else None
    _close(pencil._launch_cols(*x, luts, tw, "fused4", n1, n2),
           pencil.cols_pass_plain(*x, luts, tw, kind="fused4", n1=n1, n2=n2))


@BUDGETS
@pytest.mark.parametrize("b,p,f,w,kind", [
    (2, 4, 256, 8, "direct"), (1, 3, 100, 70, "direct"), (1, 4, 2048, 8, "fused4"),
    (2, 2, 2048, 16, "fused4"), (1, 2, 4096, 5, "fused4"),
])
def test_cols_natural_source(budget, b, p, f, w, kind):
    x = _planes(f, b, p, f, w)
    n1, n2 = (0, 0) if kind == "direct" else plan_lib.balanced_split(f)
    luts = _planes(5, f, f) if kind == "direct" else _fused(f)
    _close(pencil._launch_cols_natural(*x, luts, kind, n1, n2),
           pencil.cols_natural_plain(*x, luts, kind=kind, n1=n1, n2=n2))


@pytest.mark.parametrize("b,m", [(3, 1), (2, 8), (2, 300), (1, 1024)])
def test_recomb_source(emulated, b, m):
    n = 2 * m
    z = _planes(m, b, m)
    fwd = ops.recomb_luts("cpu", n, False)
    _close(pencil._launch_recomb(*z, *fwd, "rfft_recomb", m, m + 1),
           pencil.rfft_recomb_plain(*z, *fwd))
    x = _planes(m + 1, b, m + 1)
    inv = ops.recomb_luts("cpu", n, True)
    _close(pencil._launch_recomb(*x, *inv, "irfft_recomb", m, m),
           pencil.irfft_recomb_plain(*x, *inv))


def test_every_launch_enters_the_tensor_device(emulated):
    """Each ``_launch*`` runs under its tensor's device, so the ctypes
    launchers (which act on the runtime's current device) hit that card."""
    x = _planes(0, 2, 16)
    w = _planes(1, 16, 16)
    calls = [
        (dft_matmul._launch, (*x, *w, None, None)),
        (fft4step._launch, (*_planes(2, 1, 2048), *_fused(2048), None, None, True)),
        (pencil._launch_cols, (*_planes(3, 1, 16, 2), w, None, "direct", 0, 0)),
        (pencil._launch_rows, (*_planes(4, 1, 2, 16), w, "direct", 0, 0)),
        (pencil._launch_cols_natural, (*_planes(5, 1, 2, 16, 2), w, "direct", 0, 0)),
        (pencil._launch_recomb, (*x, *ops.recomb_luts("cpu", 32, False), "rfft_recomb", 16, 17)),
        (pencil._launch_recomb, (*_planes(6, 2, 17), *ops.recomb_luts("cpu", 32, True),
                                 "irfft_recomb", 16, 16)),
    ]
    launchers = {getattr(mod, name) for mod in (dft_matmul, fft4step, pencil)
                 for name in vars(mod) if name.startswith("_launch")}
    assert launchers == {fn for fn, _ in calls}
    for fn, args in calls:
        del emulated[:]
        fn(*args)
        assert emulated == [torch.device("cpu")]


def test_refused_launch_raises(emulated):
    """A launch the runtime refuses surfaces as KernelError, not a result."""
    x = _planes(0, 3, 2048)
    luts = _fused(2048)
    with pytest.raises(faults.KernelError, match="launch failed"):
        # lgc = 2 does not divide a batch of 3: the launcher refuses it.
        build.check(build.function("repro_fft4step", fft4step._ARGS)(
            3, 64, 32, 2, 1, *map(build.ptr, (*x, *luts)), None, None,
            *map(build.ptr, x), None, None, 0), "fft4step")
