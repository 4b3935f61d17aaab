"""Planner, LUT tables, error taxonomy and the plan-and-execute API.

  limits      regime thresholds and the shared-memory budget
  faults      typed errors and the fault-injection registry
  twiddle     float64 host LUT tables (the paper's texture-memory stage)
  plan        the HBM-round-trip pass program (pure metadata)
  fft_torch   plain split-plane torch FFT math (CPU route, kernel oracle)
  fft         FFTSpec → plan() → PlannedFFT over a backend registry
  conv        FFT convolution (1-D, 2-D, packed) on the planned FFTs
  overlap     overlap-save convolution and StreamingConv
  tuning      the autotuner: modes, roofline pruning, the persistent cache
  distributed the pencil FFT over torch.distributed (pfft, pifft, pfft2d,
              pconv_os_sharded)
"""

from repro_torch.core import conv, distributed, faults, fft, fft_torch, limits, overlap, plan, tuning, twiddle
from repro_torch.core.faults import KernelError, PlanError, ReproError
from repro_torch.core.fft import FFTSpec, PlannedFFT
from repro_torch.core.plan import FFTPlan, plan_fft

__all__ = [
    "conv",
    "distributed",
    "overlap",
    "faults",
    "fft",
    "fft_torch",
    "limits",
    "plan",
    "twiddle",
    "tuning",
    "KernelError",
    "PlanError",
    "ReproError",
    "FFTSpec",
    "PlannedFFT",
    "FFTPlan",
    "plan_fft",
]
