"""fftbench: the paper's own workload as a first-class config.

Port of ``src/repro/configs/fftbench.py``, a copy of its data: batched 1-D
complex FFTs at the Table-1 sizes and the pod-scale lengths the distributed
layer targets, the SAR-representative 2-D workload (range and azimuth
transforms over a 4096 × 8192 scene) and a 2^19-point convolution.  The dry
run (:mod:`repro_torch.launch.dryrun`) traces the distributed pencil FFT
(:mod:`repro_torch.core.distributed`) over the production mesh at these
shapes.
"""

import dataclasses

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class FFTShape:
    name: str
    n: int           # transform length (1-D) or rows for 2-D
    batch: int
    kind: str        # fft1d | fft2d | fftconv
    n2: int = 0      # cols for 2-D


CONFIG = ModelConfig(name="fftbench", family="fft")

# Table-1 sizes (paper) + pod-scale sizes the distributed layer targets.
FFT_SHAPES = [
    FFTShape("table1_4096", 4096, 4096, "fft1d"),
    FFTShape("table1_16384", 16384, 1024, "fft1d"),
    FFTShape("table1_65536", 65536, 256, "fft1d"),
    FFTShape("pod_1m", 2**20, 64, "fft1d"),
    FFTShape("pod_16m", 2**24, 32, "fft1d"),
    FFTShape("sar_4kx8k", 4096, 32, "fft2d", n2=8192),
    FFTShape("conv_512k", 2**19, 32, "fftconv"),
]

SHAPES = []  # LM shapes don't apply; the dry run uses FFT_SHAPES.
