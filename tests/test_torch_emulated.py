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
on a 1-D grid, ``<<<grid, block, smem, stream>>>`` launches (of templated
kernels too), ``cudaFuncSetAttribute`` for dynamic shared memory,
``cudaGetLastError`` and ``cudaFuncGetAttributes`` (which reports zero
registers and local bytes: a host build has neither).
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

from repro_torch import kernels
from repro_torch.core import faults, limits
from repro_torch.core import plan as plan_lib
from repro_torch.kernels import bluestein, build, dft_matmul, fft4step, ops, pencil

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
        # A kernel name may carry template arguments (cols_slab_kernel<NAT>).
        text = re.sub(r"(\w+(?:<[\w, ]+>)?)<<<(.+?)>>>\(", r"emu_launch(\1, \2, ", text)
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


def _roots(n, inverse=False):
    return ops._roots_luts("cpu", n, inverse)


@pytest.mark.parametrize("b,n,epilogue,inverse", [
    (3, 16, False, False), (5, 2, True, True), (70, 64, False, True), (2, 1024, True, False),
    (1, 1, False, False),
])
def test_dft_matmul_source(emulated, b, n, epilogue, inverse):
    """The radix kernel at powers of two, ragged last tiles included (a tile
    is 4096 points: 70 signals of 64, 5 of 2)."""
    x = _planes(b, b, n)
    w = _roots(n, inverse)
    e = _planes(1, n) if epilogue else (None, None)
    _close(dft_matmul._launch(*x, *w, *e, inverse),
           dft_matmul.dft_matmul_plain(*x, *w, inverse=inverse, twiddle=e if epilogue else None))


@BUDGETS
@pytest.mark.parametrize("b,n,natural,epilogue", [
    (4, 2048, True, False), (3, 2048, False, True), (2, 4096, True, True), (1, 32768, False, False),
])
def test_fft4step_source(budget, b, n, natural, epilogue):
    """The whole signal in shared memory while it fits the budget, else the
    four-step through the scratch slab (the small budget sends every length
    there; n = 32768 goes there on the H100 too)."""
    x = _planes(n, b, n)
    w = _roots(n)
    n1 = plan_lib.balanced_split(n)[0]
    e = _planes(2, n) if epilogue else (None, None)
    _close(fft4step._launch(*x, *w, *e, n1, False, natural),
           fft4step.fft4step_plain(*x, *w, n1=n1, natural_order=natural,
                                   twiddle_after=e if epilogue else None))


@pytest.mark.parametrize("b,n,natural,inverse", [
    (1, 8192, True, False), (2, 8192, False, True), (1, 16384, False, False), (1, 16384, True, True),
])
def test_fft4step_tile_source(emulated, b, n, natural, inverse):
    """The larger whole-signal tiles (512 threads, 16 and 32 points each) in
    both orders and directions."""
    x = _planes(n, b, n)
    w = _roots(n, inverse)
    n1 = plan_lib.balanced_split(n)[0]
    e = _planes(3, n)
    _close(fft4step._launch(*x, *w, *e, n1, inverse, natural),
           fft4step.fft4step_plain(*x, *w, n1=n1, inverse=inverse, natural_order=natural,
                                   twiddle_after=e))


SLAB = pencil.SLAB


def _cols(x, tw, tile, inverse=False, tw_every=1):
    """The column kernel (emulated) against its plain version."""
    f = x[0].shape[1]
    w = _roots(f, inverse)
    _close(pencil._launch_cols(*x, *w, tw, inverse, 0, tw_every, tile),
           pencil.cols_pass_plain(*x, *w, tw, inverse=inverse, tw_every=tw_every))


@pytest.mark.parametrize("r,f,s,tile,with_twiddle,inverse", [
    (2, 256, 64, 12, True, False), (3, 256, 70, 13, False, True), (2, 512, 40, 14, True, False),
    (2, 1024, 8, 13, True, True), (1, 2048, 16, 14, True, False), (2, 1024, 12, SLAB, True, False),
    (1, 4096, 16, None, True, True), (1, 4096, 16, SLAB, False, True), (3, 2, 5, None, True, False),
    (2, 1, 3, None, True, False),
])
def test_cols_pass_source(emulated, r, f, s, tile, with_twiddle, inverse):
    """Every on-chip tile (4096, 8192, 16384 points: 2^t / f adjacent
    columns a block, ragged width 70 at f = 256), the slab four-step
    (8 columns a block), the table's default, f = 2 and 1."""
    _cols(_planes(f, r, f, s), _planes(4, f, s) if with_twiddle else None, tile, inverse)


@pytest.mark.parametrize("b,p,f,tile,inverse", [
    (2, 64, 256, 12, False), (3, 70, 256, 13, True), (2, 16, 512, 14, False),
    (2, 16, 2048, 14, True), (1, 8, 4096, None, False), (2, 13, 1024, SLAB, False),
    (1, 9, 4096, SLAB, True), (3, 5, 2, None, False), (2, 40, 64, 12, True),
    (1, 3, 16384, None, False),
])
def test_rows_natural_source(emulated, b, p, f, tile, inverse):
    """The transposed-write row kernel at every tile, ragged row counts
    (70, 13, 9, 5, 3: the last chunk is masked), the slab four-step and
    f = 2."""
    x = _planes(f, b, p, f)
    w = _roots(f, inverse)
    _close(pencil._launch_rows(*x, *w, inverse, 0, tile),
           pencil.rows_natural_plain(*x, *w, inverse=inverse))


@pytest.mark.parametrize("r,f,s,tile,tw_every", [
    (2, 256, 32, 12, 8), (1, 128, 12, 13, 4), (2, 2048, 32, 14, 16), (1, 4096, 16, None, 4),
    (1, 2048, 8, None, 2), (1, 4096, 16, SLAB, 4), (1, 1024, 32, SLAB, 8), (2, 512, 64, 13, 32),
])
def test_cols_pass_tw_every_source(emulated, r, f, s, tile, tw_every):
    """The width-broadcast twiddle of a strip-mined column factor by shift
    (tw_every a power of two), in every form."""
    _cols(_planes(f, r, f, s), _planes(4, f, s // tw_every), tile, tw_every=tw_every)


@pytest.mark.parametrize("tile", [None, SLAB])
@pytest.mark.parametrize("r,f,s,with_twiddle", [
    (1, 2048, 13, True), (2, 2048, 3, False), (1, 4096, 9, True), (2, 2048, 1, True),
])
def test_cols_pass_ragged_width_source(emulated, tile, r, f, s, with_twiddle):
    """An odd width: the last chunk of columns is masked, and nothing past
    the width is read or written (on-chip tile and slab)."""
    _cols(_planes(f, r, f, s), _planes(4, f, s) if with_twiddle else None, tile)


def test_radix_passes_refuse_other_lengths_source(emulated):
    """A column or row length that is no power of two raises PlanError
    before anything launches, and the launcher itself refuses it, as it
    refuses a tile that cannot hold f (the slab form below 1024 points, an
    on-chip tile shorter than f)."""
    x = _planes(0, 2, 100, 3)
    w = _planes(1, 100)
    with pytest.raises(faults.PlanError, match="power of two"):
        pencil.cols_pass_call(*x, *w)
    with pytest.raises(faults.PlanError, match="power of two"):
        pencil.rows_natural_call(*_planes(2, 2, 3, 100), *w)
    with pytest.raises(faults.KernelError, match="launch failed"):
        pencil._launch_cols(*x, *w, None, False)
    with pytest.raises(faults.KernelError, match="launch failed"):
        pencil._launch_cols(*_planes(3, 1, 512, 2), *_roots(512), None, False, tile=SLAB)
    with pytest.raises(faults.KernelError, match="launch failed"):
        pencil._launch_rows(*_planes(4, 1, 2, 8192), *_roots(8192), False, tile=12)


@pytest.mark.parametrize("b,p,f,w,tile,inverse", [
    (2, 3, 256, 64, 12, False), (1, 4, 256, 70, 13, True), (2, 2, 512, 40, 14, False),
    (1, 3, 1024, 5, 13, True), (2, 2, 2048, 16, 14, False), (1, 2, 2048, 8, None, True),
    (2, 2, 1024, 12, SLAB, False), (1, 3, 4096, 5, None, True), (1, 2, 4096, 16, SLAB, False),
    (3, 5, 2, 70, None, False), (2, 2, 1, 3, None, True), (1, 2, 16, 300, 12, True),
    (2, 64, 64, 8, 13, False), (1, 2, 16384, 2, None, False),
])
def test_cols_natural_source(emulated, b, p, f, w, tile, inverse):
    """The digit-transposing column pass in every form (on-chip tiles of
    2^12, 2^13, 2^14 points, the slab four-step, the table's default), B
    and P above 1, ragged widths (70, 40, 5, 12, 300: the last chunk is
    masked) and widths below a tile's C columns (5 of 8, 8 of 128, 70 of
    2048), forward and inverse, f = 1 and 2."""
    x = _planes(f, b, p, f, w)
    r = _roots(f, inverse)
    _close(pencil._launch_cols_natural(*x, *r, inverse, 0, tile),
           pencil.cols_natural_plain(*x, *r, inverse=inverse))


@pytest.mark.parametrize("b,f,w,tile,inverse", [
    (2, 256, 40, 12, False), (1, 512, 70, 13, True), (2, 2048, 24, 14, False),
    (1, 4096, 9, SLAB, True), (2, 1024, 16, SLAB, False),
])
def test_cols_natural_one_group_is_cols_pass_source(emulated, b, f, w, tile, inverse):
    """With P = 1 the digit transpose is the identity: cols_natural's launch
    writes exactly what cols_pass's writes without a twiddle, in every
    form (the same engine, another output base and stride)."""
    x = _planes(f + 1, b, f, w)
    r = _roots(f, inverse)
    nat = pencil._launch_cols_natural(*(a.view(b, 1, f, w) for a in x), *r, inverse, 0, tile)
    col = pencil._launch_cols(*x, *r, None, inverse, 0, 1, tile)
    for a, c in zip(nat, col):
        assert torch.equal(a.view(b, f, w), c)


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


@pytest.mark.parametrize("r,f,s,tile,tw_every", [
    (1, 256, 24, 12, 12), (2, 128, 30, 13, 5), (1, 2048, 24, 14, 12), (1, 2048, 20, SLAB, 10),
    (1, 4096, 9, None, 3), (1, 4096, 9, SLAB, 3), (2, 512, 21, 14, 7),
])
def test_cols_pass_tw_every_any_width_source(emulated, r, f, s, tile, tw_every):
    """A width-broadcast twiddle whose run of columns is no power of two
    (the strided factor of fft2 at a non-power-of-two row length): the
    twiddle column is c / tw_every, per element, in every form; a tile
    may straddle two runs."""
    _cols(_planes(f, r, f, s), _planes(4, f, s // tw_every), tile, tw_every=tw_every)


def _bluestein_args(n, inverse):
    """(the planner's first factor of the pad, fwd luts, inv luts) of the
    fused stages at n."""
    fwd, inv = plan_lib.plan_fft(n).passes
    return (plan_lib._leaf_pass(fwd.n1).n1, ops._bluestein_luts("cpu", fwd, inverse),
            ops._bluestein_luts("cpu", inv, inverse))


def _bluestein(b, n, inverse):
    """Both fused stages (emulated) against their plain versions."""
    in1, fwd_luts, inv_luts = _bluestein_args(n, inverse)
    m = plan_lib.bluestein_pad(n)
    x = _planes(n, b, n)
    _close(bluestein._launch_fwd(*x, fwd_luts, n, m, in1),
           bluestein.bluestein_fwd_plain(*x, fwd_luts, n=n, m_pad=m))
    y = _planes(m, b, m)
    _close(bluestein._launch_inv(*y, inv_luts, n, m, in1),
           bluestein.bluestein_inv_plain(*y, inv_luts, n=n, m_pad=m))


@BUDGETS
@pytest.mark.parametrize("b,n,inverse", [(3, 97, False), (70, 97, True), (2, 1000, False),
                                         (3, 1000, True), (1, 2029, False), (1, 8193, True)])
def test_bluestein_fused_source(budget, b, n, inverse):
    """The fused stages in the 4096-point tile (n = 97, M = 256: 16 signals
    a tile, the last of 70 ragged; n = 1000, M = 2048; n = 2029, M = 4096)
    and the slab four-step (n = 8193, M = 32768, as on the H100; the small
    budget sends every pad past 1024 there)."""
    _bluestein(b, n, inverse)


@pytest.mark.parametrize("b,n,inverse", [(2, 3000, False), (1, 3000, True), (1, 4999, False)])
def test_bluestein_tile_source(emulated, b, n, inverse):
    """The larger whole-signal tiles: M = 8192 (512 threads) and 16384
    (1024 threads), one signal a block."""
    _bluestein(b, n, inverse)


@pytest.mark.parametrize("b,n,m", [(3, 300, 1024), (2, 97, 256)])
@pytest.mark.parametrize("stage", bluestein.STAGES)
def test_bluestein_elem_source(emulated, b, n, m, stage):
    w_in, w_out, w_lut = bluestein._elem_widths(stage, n, m)
    x = _planes(w_in, b, w_in)
    lut = _planes(w_lut, w_lut)
    _close(bluestein._launch_elem(*x, lut, w_in, w_out),
           bluestein.bluestein_elem_plain(*x, lut, stage=stage, n=n, m_pad=m))


def test_kernel_attribute_entries(emulated):
    """The register guard's C entries: every source with kernels answers
    for each of them (the host build reports zero registers), and the
    recorded table has a row for each function, no more."""
    attrs = build.kernel_attributes()
    assert set(attrs) == set(build.RECORDED_ATTRS)
    for name, row in attrs.items():
        assert row["source"].endswith(".cu") and row["registers"] == 0 and row["local_bytes"] == 0
    assert build.attribute_faults(attrs) == []


@pytest.mark.parametrize("name,registers,local,faults", [
    ("cols_slab_kernel", 64, 0, 0),
    ("cols_slab_kernel", 64, 16, 1),
    ("cols_radix_kernel<512, 16, natural>", 64, 0, 0),
    ("cols_slab_kernel<natural>", 255, 8, 1),
    ("rows_radix_kernel<1024, 16>", 200, 0, 0),
    ("unrecorded_kernel", 32, 4, 1),
])
def test_attribute_faults_rule(name, registers, local, faults):
    """The guard's rule: local bytes up to the recorded row (none for a
    function without one); registers are not bounded by it."""
    row = {"source": "x.cu", "registers": registers, "local_bytes": local}
    assert len(build.attribute_faults({name: row})) == faults


def _launch_calls(b):
    """{kernel: (its ``_launch*``, arguments over a batch of b, the output
    shape)} for every launcher of the wrapper modules."""
    fwd_luts, inv_luts = _bluestein_args(5, False)[1:]
    return {
        "dft_matmul": (dft_matmul._launch, (*_planes(0, b, 16), *_roots(16), None, None, False),
                       (b, 16)),
        "fft4step": (fft4step._launch, (*_planes(2, b, 2048), *_roots(2048), None, None, 64,
                                        False, True), (b, 2048)),
        "cols_pass": (pencil._launch_cols, (*_planes(3, b, 16, 2), *_roots(16), None, False),
                      (b, 16, 2)),
        "rows_natural": (pencil._launch_rows, (*_planes(4, b, 2, 16), *_roots(16), False),
                         (b, 16, 2)),
        "cols_natural": (pencil._launch_cols_natural, (*_planes(5, b, 2, 16, 2), *_roots(16),
                                                       False), (b, 16, 2, 2)),
        "rfft_recomb": (pencil._launch_recomb, (*_planes(0, b, 16),
                                                *ops.recomb_luts("cpu", 32, False),
                                                "rfft_recomb", 16, 17), (b, 17)),
        "irfft_recomb": (pencil._launch_recomb, (*_planes(6, b, 17),
                                                 *ops.recomb_luts("cpu", 32, True),
                                                 "irfft_recomb", 16, 16), (b, 16)),
        "bluestein_fwd": (bluestein._launch_fwd, (*_planes(7, b, 5), fwd_luts, 5, 16), (b, 16)),
        "bluestein_inv": (bluestein._launch_inv, (*_planes(8, b, 16), inv_luts, 5, 16), (b, 5)),
        "bluestein_elem": (bluestein._launch_elem, (*_planes(9, b, 5), _planes(10, 5), 5, 16),
                           (b, 16)),
    }


def test_every_launch_enters_the_tensor_device(emulated):
    """Each ``_launch*`` runs under its tensor's device, so the ctypes
    launchers (which act on the runtime's current device) hit that card."""
    calls = list(_launch_calls(2).values())
    launchers = {getattr(mod, name) for mod in (dft_matmul, fft4step, pencil, bluestein)
                 for name in vars(mod) if name.startswith("_launch")}
    assert launchers == {fn for fn, _, _ in calls}
    for fn, args, _ in calls:
        del emulated[:]
        fn(*args)
        assert emulated == [torch.device("cpu")]


@pytest.mark.parametrize("kernel", [
    "dft_matmul", "fft4step", "cols_pass", "rows_natural", "cols_natural", "rfft_recomb",
    "irfft_recomb", "bluestein_fwd", "bluestein_inv", "bluestein_elem"])
def test_empty_batch_launches_nothing_source(emulated, kernel):
    """A batch of 0: every launcher returns the empty output of the shape
    the kernel would have written, launches nothing and counts nothing (the
    C entries refuse B < 1, so a launch would raise)."""
    fn, args, shape = _launch_calls(0)[kernel]
    kernels.reset_counts()
    yr, yi = fn(*args)
    assert tuple(yr.shape) == tuple(yi.shape) == shape and yr.dtype == torch.float32
    assert not any(kernels.counts().values())


def test_refused_launch_raises(emulated):
    """A launch the runtime refuses surfaces as KernelError, not a result."""
    x = _planes(0, 3, 2048)
    with pytest.raises(faults.KernelError, match="launch failed"):
        # n1 = 16 is under the kernel's shortest factor: the launcher refuses it.
        build.check(build.function("repro_fft4step", fft4step._ARGS)(
            3, 2048, 16, 1, 0, *map(build.ptr, (*x, *_roots(2048))), None, None,
            *map(build.ptr, x), None, None, 0), "fft4step")
