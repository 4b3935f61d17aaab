"""Build the CUDA kernels at first use and bind them with ctypes.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all started
together, and linked into one shared library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -c csrc/<name>.cu      (one per source, in parallel)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared *.o -o lib...so

The library lands in ``build/repro_torch_kernels/`` of the checkout (or
``$REPRO_TORCH_BUILD_DIR``) under a name carrying the hash of every source
and flag, so an edited source rebuilds and an unchanged one loads at once.
No PyTorch header is compiled: pointers, sizes and the stream cross the
boundary as ``c_void_p`` / ``c_int64``, and every entry point returns the
``cudaError_t`` of its launch, which :func:`check` turns into a
:class:`~repro_torch.core.faults.KernelError`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

from repro_torch.core.faults import KernelError, PlanError

__all__ = [
    "ARCH_FLAGS",
    "NVCC_FLAGS",
    "PTR",
    "I64",
    "csrc_dir",
    "build_dir",
    "find_nvcc",
    "source_digest",
    "compile_commands",
    "build",
    "library",
    "function",
    "check",
    "on_device",
    "stream_ptr",
    "ptr",
    "check_planes",
    "kernel_attributes",
    "RECORDED_ATTRS",
    "attribute_faults",
]

#: Hopper with the architecture-specific features (``wgmma``, ``setmaxnreg``).
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")

PTR = ctypes.c_void_p
I64 = ctypes.c_int64

#: Where nvcc is looked for when neither ``$CUDA_HOME`` nor ``$PATH`` has it.
DEFAULT_CUDA_HOME = "/usr/local/cuda"

_LOCK = threading.Lock()


def csrc_dir() -> Path:
    return Path(__file__).resolve().parent.parent / "csrc"


def build_dir() -> Path:
    """``$REPRO_TORCH_BUILD_DIR``, else ``build/repro_torch_kernels`` at the
    root of the checkout holding this package (``src/repro_torch``)."""
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``$PATH``, then
    ``/usr/local/cuda/bin``.  Raises :class:`KernelError` when none has it."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(on_path)
    cands.append(os.path.join(DEFAULT_CUDA_HOME, "bin", "nvcc"))
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise KernelError(
        "nvcc not found: the CUDA kernels are built from csrc/ at first use "
        "and need the CUDA toolkit (set CUDA_HOME or put nvcc on PATH)",
        site="kernel.build",
    )


def _sources() -> tuple[list[Path], list[Path]]:
    d = csrc_dir()
    return sorted(d.glob("*.cu")), sorted(d.glob("*.cuh"))


def source_digest() -> str:
    """Hash of every source, header and flag: the library's name."""
    cus, cuhs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in cus + cuhs:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def compile_commands(nvcc: str, out_dir: Path) -> tuple[list[list[str]], list[str], Path]:
    """(one compile command per ``.cu``, the link command, the library path)."""
    out_dir = Path(out_dir)
    cus, _ = _sources()
    objs = [out_dir / (src.stem + ".o") for src in cus]
    compiles = [
        [nvcc, *NVCC_FLAGS, "-I", str(csrc_dir()), "-c", str(src), "-o", str(obj)]
        for src, obj in zip(cus, objs)
    ]
    lib = out_dir / f"librepro_torch_{source_digest()}.so"
    link = [nvcc, *ARCH_FLAGS, "-shared", *map(str, objs), "-o", str(lib)]
    return compiles, link, lib


def build() -> dict:
    """Build the shared library unless the current sources' one exists.

    Returns ``{"path", "compiled", "seconds", "log"}``: where the library
    is, whether this call compiled it, how long that took, and the
    compilers' output (``-Xptxas=-v`` register and spill lines)."""
    with _LOCK:
        target = build_dir() / f"librepro_torch_{source_digest()}.so"
        if target.exists():
            return {"path": str(target), "compiled": False, "seconds": 0.0, "log": ""}
        nvcc = find_nvcc()
        target.parent.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=target.parent) as tmp:
            compiles, link, lib = compile_commands(nvcc, Path(tmp))
            procs = [
                subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
                )
                for cmd in compiles
            ]
            logs = []
            failed = []
            for cmd, proc in zip(compiles, procs):
                out, _ = proc.communicate()
                logs.append(out)
                if proc.returncode != 0:
                    failed.append((cmd, out))
            if failed:
                cmd, out = failed[0]
                raise KernelError(
                    f"nvcc failed on {cmd[-3]}:\n{out}", site="kernel.build"
                )
            res = subprocess.run(link, capture_output=True, text=True)
            if res.returncode != 0:
                raise KernelError(
                    f"linking the kernels failed:\n{res.stdout}{res.stderr}",
                    site="kernel.build",
                )
            os.replace(lib, target)
        return {
            "path": str(target),
            "compiled": True,
            "seconds": time.perf_counter() - t0,
            "log": "".join(logs),
        }


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    lib = ctypes.CDLL(build()["path"])
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def function(name: str, argtypes: tuple, restype=ctypes.c_int):
    """Entry point ``name`` of the library with its ctypes signature set
    (launchers return a ``cudaError_t`` as ``int``)."""
    fn = getattr(library(), name)
    fn.argtypes = list(argtypes)
    fn.restype = restype
    return fn


def check(rc: int, name: str) -> None:
    """Raise :class:`KernelError` when a launch returned a CUDA error."""
    if rc != 0:
        msg = library().repro_error_string(rc).decode()
        raise KernelError(f"{name} launch failed: {msg} (cudaError {rc})", site="kernel.launch")


def on_device(launch):
    """Run a ``_launch*`` function with its first tensor's card as the CUDA
    runtime's current device.  The ``ctypes`` launchers (and
    ``cudaFuncSetAttribute``) act on the current device, which need not be
    the tensor's: on a host with several cards the kernel would otherwise
    run on one card with another's pointers."""

    @functools.wraps(launch)
    def run(x, *args, **kwargs):
        with torch.cuda.device(x.device):
            return launch(x, *args, **kwargs)

    return run


def stream_ptr(t) -> int:
    """The raw handle of torch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t) -> int | None:
    """Device address of a tensor for a ``c_void_p`` argument (None: NULL)."""
    return None if t is None else t.data_ptr()


def check_planes(name: str, like, **operands) -> None:
    """Validate a kernel's operands before any pointer crosses to C.

    ``operands`` maps an argument name to ``(tensor, shape)`` (``None``
    tensors are skipped): each must be float32, contiguous, of that shape,
    and on ``like``'s device.
    """
    for arg, (t, shape) in operands.items():
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise PlanError(f"{name}: {arg} must be float32, got {t.dtype}")
        if t.device != like.device:
            raise PlanError(f"{name}: {arg} is on {t.device}, the signal on {like.device}")
        if tuple(t.shape) != tuple(shape):
            raise PlanError(f"{name}: {arg} has shape {tuple(t.shape)}, expected {tuple(shape)}")
        if not t.is_contiguous():
            raise PlanError(f"{name}: {arg} must be contiguous")


def kernel_attributes() -> dict:
    """``{kernel: {"source", "registers", "local_bytes"}}`` for every
    ``__global__`` function of the library, from ``cudaFuncGetAttributes``
    through each source's ``repro_attrs_<source>`` entry: the registers
    per thread and the local (spill) bytes per thread the compiler gave
    it.  Sources without kernels have no entry."""
    lib = library()
    out = {}
    for src in _sources()[0]:
        entry = f"repro_attrs_{src.stem}"
        if not hasattr(lib, entry):
            continue
        fn = function(entry, (ctypes.c_int, ctypes.POINTER(ctypes.c_char_p),
                              ctypes.POINTER(I64), ctypes.POINTER(I64)))
        i = 0
        while True:
            name, regs, local = ctypes.c_char_p(), I64(), I64()
            rc = fn(i, ctypes.byref(name), ctypes.byref(regs), ctypes.byref(local))
            if rc == -1:
                break
            check(rc, entry)
            out[name.value.decode()] = {
                "source": src.name, "registers": regs.value, "local_bytes": local.value,
            }
            i += 1
    return out


#: (registers, local bytes) per thread of every ``__global__`` function as
#: the sm_90a build recorded in PERF.md compiled it: the register guard's
#: one table, read by ``chip_smoke.py`` and the card tests.
RECORDED_ATTRS = {
    "dft_matmul_kernel": (64, 0),
    "fft4step_kernel<256, 16>": (64, 0),
    "fft4step_kernel<512, 16>": (64, 0),
    "fft4step_kernel<1024, 16>": (64, 0),
    "fft4step_slab_kernel": (64, 0),
    "cols_radix_kernel<256, 16>": (64, 0),
    "cols_radix_kernel<512, 16>": (64, 0),
    "cols_radix_kernel<1024, 16>": (64, 0),
    "cols_slab_kernel": (64, 0),
    "cols_radix_kernel<256, 16, natural>": (64, 0),
    "cols_radix_kernel<512, 16, natural>": (64, 0),
    "cols_radix_kernel<1024, 16, natural>": (64, 0),
    "cols_slab_kernel<natural>": (64, 0),
    "rows_radix_kernel<256, 16>": (63, 0),
    "rows_radix_kernel<512, 16>": (63, 0),
    "rows_radix_kernel<1024, 16>": (63, 0),
    "rows_slab_kernel": (64, 0),
    "rfft_recomb_kernel": (24, 0),
    "irfft_recomb_kernel": (20, 0),
    "bluestein_fwd_kernel<256, 16>": (64, 0),
    "bluestein_fwd_kernel<512, 16>": (64, 0),
    "bluestein_fwd_kernel<1024, 16>": (64, 0),
    "bluestein_fwd_slab_kernel": (64, 0),
    "bluestein_inv_kernel<256, 16>": (64, 0),
    "bluestein_inv_kernel<512, 16>": (64, 0),
    "bluestein_inv_kernel<1024, 16>": (64, 0),
    "bluestein_inv_slab_kernel": (64, 0),
    "bluestein_elem_kernel": (16, 0),
}

def attribute_faults(attrs: dict) -> list:
    """The register guard over :func:`kernel_attributes`' rows: one message
    for each function with more local (spill) bytes than
    :data:`RECORDED_ATTRS` gives it (none for a function it lacks)."""
    faults = []
    for name, row in sorted(attrs.items()):
        local = RECORDED_ATTRS.get(name, (0, 0))[1]
        if row["local_bytes"] > local:
            faults.append(f"{name}: {row['local_bytes']} local bytes, the recorded build had {local}")
    return faults
