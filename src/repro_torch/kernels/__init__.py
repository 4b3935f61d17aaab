"""Hand-written CUDA kernels (sm_90a) for the FFT pass program.

dft_matmul  direct DFT complex GEMM (N <= 1024, one pass)
fft4step    fused four-step (2048 <= N <= 65536, one pass)
pencil      strided-column pass and transposed-write row pass (split regime)
ops         the pass-program executor with device-resident LUTs
build       nvcc → one shared library → ctypes, at first use
ref         numpy oracles (naive float64 DFT, four-step reference)

Each kernel module holds the kernel's wrapper (which launches the CUDA
kernel for a CUDA tensor), its plain PyTorch version (which the wrapper
takes for a CPU tensor), and a ``COUNTS`` dict of kernel launches and plain
calls.
"""

from repro_torch.kernels import build, dft_matmul, fft4step, ops, pencil, ref

#: Every kernel module carrying a ``COUNTS`` dict.
KERNEL_MODULES = (dft_matmul, fft4step, pencil)


def reset_counts() -> None:
    """Zero every kernel-launch and plain-call counter."""
    for mod in KERNEL_MODULES:
        for key in mod.COUNTS:
            mod.COUNTS[key] = 0


def counts() -> dict:
    """Snapshot ``{counter name: count}`` over every kernel module."""
    out = {}
    for mod in KERNEL_MODULES:
        out.update(mod.COUNTS)
    return out


__all__ = [
    "build",
    "dft_matmul",
    "fft4step",
    "ops",
    "pencil",
    "ref",
    "KERNEL_MODULES",
    "reset_counts",
    "counts",
]
