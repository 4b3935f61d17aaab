"""PyTorch + CUDA port of the memory-optimized FFT engine (``repro``).

The package mirrors ``repro``'s layout so each module's counterpart is easy
to find:

  core.limits      regime thresholds; shared-memory budget from torch.cuda
  core.faults      typed error taxonomy + fault-injection registry
  core.twiddle     float64 host LUT tables (DFT matrices, twiddle grids)
  core.plan        the pass-program planner (pure metadata, pass for pass
                   the reference's)
  core.fft_torch   plain split-plane torch FFT math (the CPU route)
  core.fft         FFTSpec / plan() / PlannedFFT over a backend registry
  core.conv        fft_conv, fft_conv2d, fft_conv_packed on the planned FFTs
  core.overlap     overlap-save convolution and StreamingConv
  core.tuning      the autotuner: modes, roofline pruning, the seeded
                   persistent cache, CUDA-event measurement on the card
  analysis         the roofline model: modelled HBM bytes of programs
  data             package data: the tuner's seed
  kernels.build    nvcc → shared library → ctypes, at first use
  kernels.*        the hand-written sm_90a CUDA kernels, each beside its
                   plain PyTorch version
  kernels.ops      the pass-program executor with device-resident LUTs
  configs          ModelConfig / ShapeConfig, the registry, make_reduced
  models.layers    norms, rope, embedding and head, MLP, attention, the
                   spectral mixer (an nn.Module over core.conv), MoE, Mamba2
                   (ssm) and mLSTM / sLSTM (xlstm)
  models.blocks    the residual blocks (attn, attn_local, moe, mamba2, mlstm,
                   slstm, shared_attn, spectral)
  models.stack     one block per layer, and zamba2's shared block
  models.model     DecoderLM: forward, logits, prefill, decode, caches
  serving          sampling, the prefill / insert / decode Engine and the
                   ServeSession slot pool
  launch.serve     the serving CLI (python -m repro_torch.launch.serve)
  utils.params     parameter init; the reference's values into a module

It imports torch and numpy only — never jax, never ``repro``.
"""

from repro_torch import core, kernels

__all__ = ["core", "kernels"]
