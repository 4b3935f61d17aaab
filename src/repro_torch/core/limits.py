"""Memory-hierarchy regime limits — the single source every layer consumes.

Port of ``src/repro/core/limits.py``.  The regime map (direct DFT up to
``DIRECT_MAX``, one fused four-step pass up to ``FUSED_MAX``, a two-pass
program beyond) is the reference's, unchanged: the port's planner must emit
the reference's pass program pass for pass.  What differs is where the
fast-tier budget comes from — ``torch.cuda`` device properties instead of
the JAX device list — and the H100-class shared-memory figure (see
:data:`GPU_SMEM_BUDGETS`).
"""

from __future__ import annotations

__all__ = [
    "DIRECT_MAX",
    "FUSED_MAX",
    "OS_FACTOR",
    "VMEM_BUDGET",
    "GPU_SMEM_BUDGETS",
    "GPU_SMEM_DEFAULT",
    "BLUESTEIN_MIN",
    "memory_budget",
    "next_pow2",
    "next_fast_len",
    "bluestein_pad",
]

#: Largest N executed as a single direct DFT matmul (one (B,N)x(N,N) GEMM).
DIRECT_MAX = 1024

#: Largest N executed by the fused four-step kernel in one HBM round trip.
FUSED_MAX = 65536

#: Default overlap-save block multiplier: B = next_pow2(Lh) · OS_FACTOR.
OS_FACTOR = 8

#: The reference's per-grid-step VMEM working-set budget.  Kept because the
#: planner's chunk and batch-tile models are defined against it and must
#: pick what the reference picks.
VMEM_BUDGET = 8 * 1024 * 1024

#: Per-block opt-in dynamic shared memory (bytes) for CUDA devices, keyed by
#: a lowercase substring of the device name, matched most-specific-first.
#:
#: The H100-class rows differ from the reference table (``228 * 1024`` =
#: 233,472 B): 228 KiB is the H100 SM's shared-memory carveout, but CUDA
#: reserves 1 KiB of it per block, so the most one block can opt into is
#: 227 KiB = 232,448 B (``cudaDevAttrMaxSharedMemoryPerBlockOptin``).  A
#: kernel launched with 233,472 B is refused.  :func:`memory_budget` reads
#: the device's own figure where torch exposes it and uses this table only
#: otherwise.
GPU_SMEM_BUDGETS = (
    ("h100", 227 * 1024),
    ("h200", 227 * 1024),
    ("b200", 227 * 1024),
    ("a100", 164 * 1024),
    ("a10", 164 * 1024),
    ("l4", 100 * 1024),
    ("v100", 96 * 1024),
    ("t4", 64 * 1024),
    ("p100", 64 * 1024),
)

#: Conservative fallback for unrecognized GPU names: the 48 KB static
#: shared-memory floor every CUDA generation guarantees.
GPU_SMEM_DEFAULT = 48 * 1024


def memory_budget(device_kind=None) -> int:
    """Fast-tier working-set budget (bytes).

    ``device_kind`` is a device name, a CUDA ``torch.device`` (that card), or
    None (the current CUDA device).  A card resolves through ``torch.cuda``:
    its ``shared_memory_per_block_optin`` property where torch exposes it,
    else the :data:`GPU_SMEM_BUDGETS` row matching its name.  Without a CUDA
    device — and for the names ``"cpu"``, ``""`` and any TPU name — the
    reference's ``VMEM_BUDGET`` applies, as the reference resolves a CPU
    host.
    """
    if device_kind is None or not isinstance(device_kind, str):
        import torch

        device = torch.device("cuda" if device_kind is None else device_kind)
        if device.type != "cuda" or not torch.cuda.is_available():
            return VMEM_BUDGET
        index = torch.cuda.current_device() if device.index is None else device.index
        props = torch.cuda.get_device_properties(index)
        optin = getattr(props, "shared_memory_per_block_optin", None)
        if optin:
            return int(optin)
        device_kind = props.name
    kind = device_kind.lower()
    if "tpu" in kind or kind in ("cpu", "", "interpreter"):
        return VMEM_BUDGET
    for tag, budget in GPU_SMEM_BUDGETS:
        if tag in kind:
            return budget
    if any(t in kind for t in ("nvidia", "cuda", "gpu", "rtx", "geforce", "amd", "mi3")):
        return GPU_SMEM_DEFAULT
    return VMEM_BUDGET


#: Smallest non-power-of-two length the Bluestein chirp-conv leaf accepts.
BLUESTEIN_MIN = 2


def next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def next_fast_len(n: int) -> int:
    """Smallest length ≥ ``n`` this engine transforms natively (pow2)."""
    return next_pow2(max(n, 1))


def bluestein_pad(n: int) -> int:
    """The chirp convolution length for a length-``n`` Bluestein transform:
    the next power of two holding the 2n−1 support of the circular conv."""
    return next_pow2(max(2 * n - 1, 1))
