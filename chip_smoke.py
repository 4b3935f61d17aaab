"""Quickest proof that the PyTorch/CUDA port runs on the card.

    python3 chip_smoke.py

Drives the port only (``src/repro_torch``; nothing of JAX or of the JAX
package), in phases, and fails on the first check that does not hold:

1. device — the card's name and power limit, and the build of every kernel
   from ``src/repro_torch/csrc`` (its wall time);
2. kernels — each of the ten CUDA kernels at the shapes phases 3–6 give
   it (phase 7's are recorded as it runs and held after it), against its plain PyTorch version on the same inputs
   (max|Δ| ≤ 1e-4·max|plain|), with its time, the plain version's, its bound
   (the larger of the bytes the function must move over HBM bandwidth and
   the flops it needs over the FP32 peak: 5·f·log2 f per length-f FFT and 6
   per twiddle or phasor multiply, whatever form the kernel computes it in),
   where one library call computes the same function that call's time, and
   the registers and local (spill) bytes per thread of each of its
   ``__global__`` functions (``cudaFuncGetAttributes``), held to no more
   local bytes than the recorded build had;
3. main path — ``plan(FFTSpec(n))`` forward and ``ifft`` at full-size
   remote-sensing shapes: sample rows against ``np.fft`` in complex128 at
   1e-3·max|ref|, ``ifft(fft(x)) ≈ x``, exactly ``len(plan.passes)`` kernel
   launches and no plain call in every planned call (checked and timed), the
   time per call beside one ``torch.fft.fft`` call (the library yardstick),
   and the device memory one forward call holds beyond its input;
4. offsets — two planned calls with just over 2^31 elements per plane,
   sample rows against ``np.fft``: the kernels' 64-bit addressing, and the
   device memory each call holds (planes in and out, scratch slab);
5. real and 2-D path — ``rfft``/``irfft``, ``fft2``/``ifft2`` (whole and
   strip-mined columns), ``rfft2``/``irfft2`` and ``fft`` down ``axis=-2``
   at 0.5–2 GB each, held as phase 3 holds its calls (sample rows or
   columns against ``np.fft`` in complex128, the inverse back to the input,
   exact launches), timed beside the matching ``torch.fft`` call;
6. arbitrary lengths — ``fft``/``ifft``, ``rfft``/``irfft`` (odd and even),
   ``fft2``/``ifft2`` and ``fft`` down ``axis=-2`` at non-power-of-two
   SAR lengths (500 … 100003) through the Bluestein kernels, fused and
   split regime, held as phase 5 holds its calls;
7. convolution — ``fft_conv`` (one shot at h2o-danube-1.8b's width,
   auto-routed to overlap-save, ``pad="exact"``), ``StreamingConv`` strip
   ingest, ``fft_conv2d`` SAR range compression, ``fft_conv_packed``, and
   ``SpectralMixer`` prefill plus 512 stream-decode tokens: every output
   held against the same convolution (the mixer: the same forward) through
   ``torch.fft`` in float64 at 1e-3·max|ref|, and sample rows against
   ``np.fft`` in complex128 (the mixer: the direct sum) as a second witness,
   to exactly Σ ``len(plan.passes)`` launches over the plans it runs, timed
   beside the same convolution through ``torch.fft.rfft``/``irfft`` in
   float32, with its peak device memory and the device time of its kernels
   and of everything else by the profiler's names (``torch.profiler``); the
   mixer's stream decode also against its one-shot forward and the ring
   decode, planning nothing new (``plan_log``).  Then every distinct kernel
   call the phase made (kernel, shape, LUTs, keywords; recorded around the
   wrappers) is held against its plain version as phase 2 holds its rows;
8. serving — h2o-danube-1.8b with ``use_spectral_mixer`` at full width
   (24 layers, 1.90 B fp32 parameters from a seed) built on the card and
   served through ``ServeSession``: prompts of 4096, 1000 and 37 tokens in
   4 slots, 96 steps, a 2048-token prompt inserted into the running batch,
   416 steps (two stream flushes), at the config's bf16 compute (timed:
   prefill per length, ms per decode step and per flush step, tokens/s,
   the device-busy share of a step by the profiler, peak memory); then the
   same requests at float32 compute on the same weights, every served
   logit row against one teacher-forced ``logits_fn`` at 1e-3·max|ref| and
   the bf16 prefill logits against the float32 ones at 5e-2·max|ref|,
   launches exactly those of the plans the prefills, inserts, flushes and
   ``logits_fn`` run, no new plan in the warm session; then each distinct
   kernel call against its plain version, as phase 7;
9. the tuner — each spec planned with ``tune="off"``, ``"model"`` and
   ``"measure"`` (CUDA-event timing of the pruned candidates on the card,
   the shipped seed set aside so the first measure plan measures) at the
   sizes users run and phases 3–7 use: the Table 1 lengths 1024 … 65536,
   2^17 and 2^20 at phase 3's batches, the SAR scene ``fft2`` (4096, 8192),
   ``fft`` 3000 and 100003 with their pad alternatives, phase 7's
   overlap-save block of (32, 2^20) ⊛ 4097, a ``StreamingConv`` keyed to
   65536-sample chunks, and ``stream_plan_info`` of h2o-danube-1.8b.  Each
   plan's output against ``torch.fft`` in float64 at 1e-3·max|ref|, exactly
   ``len(passes)`` launches (0 over a batch of 0), its forward ms (CUDA
   events, median of 3, warm) and the measurements its planning made; a
   second ``plan()`` and one through a fresh ``TuningCache`` over the same
   file make none.  Then each distinct kernel call the phase made, every
   form the tuner timed included, against its plain version
   ("kernel_check ... tune path #i" lines, not timed);
10. gradients and training — (a) the backward of every kind at the
   batches of phases 3, 5 and 6 (fft 1024, 16384, 2^20; fft2 with
   strip-mined columns; rfft / irfft 8192; fft 3000; fft 100003): the vjp
   through the kernels against ``torch.fft``'s autograd in float64 (irfft:
   the port's CPU route on sample rows), the dot test ⟨F x, g⟩ = ⟨x, Fᴴ g⟩
   in float64, exactly the opposite direction's launches and no plain
   call, timed beside ``torch.fft``'s backward ("grad" lines); (b)
   ``SpectralMixer`` (2, 4096, 2560), Lf 1024, forward and backward, every
   gradient against the same module with its convolution through
   ``torch.fft`` in float64, fwd+bwd ms beside the float32 swap, the FFT
   kernels' share ("grad_mixer"); (c) h2o-danube-1.8b + use_spectral_mixer
   at full width trained at bf16 with remat and AdamW, B = 2, S = 4096,
   8 steps on one repeated batch: finite and falling loss, each step's
   launches exactly its plans' (forward, recompute, backward), no plan
   after the first step, one float32 step's loss and gradients against
   the float64 conv swap, step ms, tokens/s, busy share, FFT kernel ms,
   optimizer ms, peak memory; then a checkpoint save and resume mid-run at
   2 layers of the same width ("train" line).  Then each distinct kernel
   call of the phase against its plain version, as phase 7;
11. the MoE block — deepseek-moe-16b with ``use_spectral_mixer`` at full
   width (``("spectral", "moe") × 14``, d_model 2048, 64 experts top-6 and
   2 shared, 8.98 B fp32 parameters from a seed) served as phase 8 serves
   (prompts 4096, 1000, 37; 32 steps; a 2048-token prompt inserted; 256
   steps, one stream flush): (a) bf16 at the config's capacity, timed
   (prefill per length, ms per decode step and per flush step, tokens/s)
   and profiled (device ms by class: expert products, routing and
   dispatch, weight casts, attention, the FFT kernels; the busy share; the
   eager ops of a step); (b) float32 at the same capacity, the four
   prefills: the bf16 prefill logits within 5e-2·max|ref| of them, and the
   share of (token, layer) top-6 sets that differ; (c) float32 with
   ``capacity_factor`` = 64/6, where no assignment can drop (0 checked in
   every layer and call): every served logit row within 1e-3·max|ref| of a
   teacher-forced ``logits_fn``; every served row finite and its token the
   greedy one; each prefill's dropped assignments and capacity; launches
   exactly those of the plans the spectral layers run, no plan when warm;
   peak memory ("serve_moe" line).  Then each distinct kernel call against
   its plain version, as phase 7;
12. the recurrent LMs — zamba2-2.7b (``(mamba2 × 6, shared_attn) × 9``,
   d_model 2560, one shared attention block run at 9 positions, 2.42 B
   fp32 parameters) and xlstm-125m (``(mlstm, mlstm, slstm) × 4``, d_model
   768, 0.198 B) at full width from a seed, each served as phase 8 serves
   but with prompts of 4096, 1024 and 37 tokens (the chunk rule: at most
   one chunk of 256, or whole chunks): bf16 timed (prefill per length,
   insert, ms per decode step, tokens/s) and profiled (device ms by class:
   weight casts, projections, the SSD or GLA chunk work, the sLSTM loop,
   attention; the busy share), then float32 on the same weights, every
   served logit row within 1e-3·max|ref| of a teacher-forced ``logits_fn``
   at the longest length the chunk rule admits (4608, 1536, 512, 2304) and
   the bf16 prefill logits within 5e-2·max|ref| of the float32 ones; a
   1000-token prompt raises the chunk rule's ``ValueError``; no FFT kernel
   launches and no plan is made ("serve_recurrent" lines);
13. the modality frontends — (a) musicgen-large with
   ``use_spectral_mixer`` (``("spectral", "attn") × 24``, d_model 2048,
   3.18 B fp32 parameters from a seed): prompts of 4096, 2048, 1000 and 37
   seeded bf16 frame embeddings, each prefilled and joined into one
   4-slot decode state (each slot at its own ``t``; the batch's stream
   phase set so that one flush falls in the steps), 64 steps fed through
   ``embeds=`` and 8 through the token table, at bf16 (timed, profiled by
   class: weight casts, GEMMs, score passes, a decode step's attention,
   the FFT kernels) and at float32 on the same weights, every served
   logit row within 1e-3·max|ref| of a teacher-forced forward over the
   same frames, the bf16 prefill logits within 5e-2·max|ref| of the
   float32 ones, launches exactly the spectral layers' plans and no plan
   in the warm float32 serve; then the plain musicgen-large (48 ``attn``,
   3.23 B) the same way with one 4096 prompt and 16 steps; (b)
   qwen2-vl-72b at every published width and 8 of its 80 layers (9.51 B):
   four prompts of a 32 × 32 grid of seeded bf16 vision embeddings and
   3072 / 2048 / 976 / 37 text tokens with qwen2-vl's M-RoPE ids, decoded
   32 steps with ids that continue the text's (apart from the KV slot
   ``t``): bf16 with the int8 cache timed and profiled; float32 with the
   cache in the compute dtype within 1e-3·max|ref| of teacher forcing (the
   head only at the checked positions); float32 with the int8 cache fed
   the same tokens within 0.03·max|ref| of it; bf16 prefill within
   5e-2·max|ref| of float32; ids equal to the positions give RoPE's
   logits; the engine then serves text prompts (standard RoPE, int8) at 4
   slots with a late insert, timed; no FFT launch, no plan
   ("serve_frontend" lines).  Then each distinct kernel call against its
   plain version, as phase 7;
14. the distributed pencil FFT (``repro_torch.core.distributed``) — (a) one
   rank over NCCL in this process at fftbench's sizes: ``pfft`` /
   ``pifft`` natural and in pencil layout at 2^24 × 32 (pod_16m; the plan
   collapses to the local program, 0 collectives) and ``pfft2d`` at
   4096 × 8192 × 32 (sar_4kx8k); (b) four spawned ranks on this one card
   over gloo (whose all-to-all stages CUDA tensors through the host: its
   times are the host's wire, not NVLink): the four calls at 2^20 × 64
   (pod_1m) and 2^24 × 4, K = 2 and 4 at 2^20 × 64, ``pack=False`` at
   2^20 × 8, ``pfft2d`` at 4096 × 8192 × 4, ``pconv_os_sharded`` at
   (32, 2^19) ⊛ 4097 taps (conv_512k) with the modelled block, and
   Parseval's gradient 2n·x at 2^20 × 2.  Every rank builds the global
   input from the seed and holds its shard against ``torch.fft`` in
   complex128 of it, sliced, at 5e-5·max|ref| (the conv in float64 at
   1e-4), round trips and the gradient at 5e-5; each call launches
   exactly its local plans' kernels and ``PencilPlan.a2a_count``
   collectives; no plain version runs; a rank that fails or hangs fails
   the phase.  Lines: ``pencil`` per case and rank (errors, collectives,
   ms per call, the local stages' ms alone by CUDA events, one packed
   all-to-all of the slab, ``pencil_report``'s local bytes over 3.35 TB/s
   as the local bound, peak memory, the card's name and power limit),
   ``pencil_rank`` (launches, collectives, peak), and each rank's distinct
   kernel calls against their plain versions ("kernel_check" lines; (a)'s
   in this process).  A build whose gloo refuses CUDA tensors fails the
   phase (the probe's error on stderr);
15. sharded training (``repro_torch.sharding``: parameters as ``DTensor``
   shards by the reference's rules, a unit per block gathered over
   ``data``, the layers on model shards) — (a) one rank over NCCL in this
   process: phase 10 (c)'s run (h2o-danube-1.8b + use_spectral_mixer at
   full width, B 2, S 4096, bf16, remat, AdamW) on a 1×1 ``DeviceMesh``,
   3 steps: every parameter a ``DTensor``, 0 collectives, phase 10 (c)'s
   launches a step, the losses within 5e-2 of phase 10 (c)'s; then the
   one-device references of (b) and (c) on the card from seed 0; then four
   spawned ranks on this card over gloo: (b) the same model cut to 4 of 24
   layers, 2×2 (data, model) with FSDP, B 4, S 2048, float32, 3 steps:
   losses within 1e-4 relative and every rank's parameter shards within
   1e-4·max|p| of the one-device run's; (d) (b)'s state saved at 2×2
   (topology-free, rank 0 writes), restored at 4×1 on the same ranks, one
   more step equal (1e-4) to a step of the uninterrupted 2×2 run;
   (c) deepseek-moe-16b + use_spectral_mixer at full width cut to 2 layers,
   experts over ``model``, B 4, S 1024, float32, 2 steps: losses and aux
   within 1e-4 and the dropped counts equal to the one-device run's.
   Every step launches exactly phase 10's expectation and exactly the
   collectives ``shard.step_collectives`` predicts.  Lines: ``sharded``
   per case and rank (ms a step on the host clock after a barrier,
   collectives by kind and their bytes, peak, errors), ``sharded_rank``
   (launches), and each rank's distinct kernel calls against their plain
   versions ("kernel_check ... sharded" lines).  A gloo rank that refuses
   CUDA tensors fails the phase;
16. the dry run held against the card (``repro_torch.launch.dryrun``: a
   cell's real step on fake tensors as rank 0 of a ``fake`` process group,
   counted by ``repro_torch.analysis.trace``) — (e)'s production cells
   start in a CPU-only subprocess (no card: ``CUDA_VISIBLE_DEVICES``
   empty) while (a)–(d) run here: (a) phase 10 (c)'s step traced on a
   fake 1×1 group, then two real steps of the one-device model (the first
   profiled: ``torch.profiler``'s ``with_flops`` over the mm / bmm ops
   that ran a kernel; the second timed, its peak after a reset): the
   launches equal, the traced peak within 10 % of the measured (the
   process's other tensors taken out), the traced dot flops within 1 %,
   the trace's lower bound at most the measured step; (b) the same for
   phase 8's 4096-token prefill, a decode step at 4 slots of the bf16
   model and the step that flushes its spectral streams (the caches at
   phase C − 1; kernels #1, #2, #6); (c) phase 14 (a)'s ``pfft`` at 2^24 × 32 and ``pfft2d`` at
   4096 × 8192 × 32 traced at world 1 and run on one rank: the artifact's
   leaf lengths, round trips and all-to-all count are the plan's that ran,
   the launches equal, the traced bytes over 3.35 TB/s at most the
   measured ms; (d) sharded serving: at world 1 over NCCL at full width,
   float32, phase 8's prompts through the model's prefill and 16 greedy
   steps, then the same weights on a 1×1 mesh: the same tokens, logits
   within 1e-3·max|ref|, no collective; on four spawned gloo ranks on the
   card, 2×2 (the parameters replicated over ``data``): h2o-danube-1.8b +
   spectral at 4 layers and deepseek-moe-16b + spectral at 2 layers
   (experts over ``model``), a prefill of each rank's rows and 8
   teacher-forced decode steps within 1e-4·max|ref| of the one-device run
   on the rank, every step's collectives equal to
   ``shard.decode_collectives`` and to the trace of the same cell on a
   fake group of 4; (e) h2o-danube-1.8b train_4k and decode_32k at 16×16,
   arctic-480b train_4k at 2×16×16, deepseek-moe-16b prefill_32k at 16×16,
   fftbench pod_16m at 16×16, gemma3-12b long_500k at 16×16 and
   zamba2-2.7b long_500k at 2×16×16 through ``run_cell``: every record
   printed, each ``ok``.  Lines: ``dryrun`` per case (launches, ms,
   peaks, dot flops, the bound and its ratio to the measured time, the
   card's name and power limit), ``dryrun_profiled``, ``dryrun_cell``
   per cell, then each distinct kernel call this process made against
   its plain version ("kernel_check ... dryrun" lines);
17. the reference's decode sharding on four spawned gloo ranks on the
   card (a CPU-only subprocess traces (a) and (c) on a fake group of 4
   meanwhile; the one-device references run here first): (a) gemma3-12b
   at full width, 6 layers (one 5:1 local/global period), float32, 2×2
   FSDP decoding weight-stationary at a batch of 1 over caches of 524288
   positions filled from seeded generators (each rank its shard of the
   same contents), 8 greedy steps at t = 524280 … 524287: the logits
   within 1e-4·max|ref| of one device, each step's collectives equal to
   ``shard.decode_collectives`` and to the trace, no all-gather over
   ``data``; (b) gemma3's global attention layer (16 heads, 8 kv of 256)
   in float32, in bf16, and in bf16 over an int8 cache, the cache's 524288
   slots over the four ranks (131072 each, a 4×1 mesh): the output within
   1e-4·max|ref| of one device over the whole cache (bf16: 2^-7, one ulp
   of its bf16 output on each side), the written slot on exactly one
   rank; (c) h2o-danube-1.8b + spectral at 4 layers, batch 1 (replicated
   over ``data``), a 512 prompt and 260 steps (one stream flush): logits
   within 1e-4·max|ref|, the decode's launches the trace's flush step's.
   Lines: ``long_reference``, ``long`` per rank (errors, collectives, ms a
   step and the peak a rank on gloo's host wire, the card's name and
   power limit), then "kernel_check ... long" lines.

Phases 2–8 and 10–17 run with ``REPRO_FFT_TUNE=off``: their expectations
(launches, kernels, forms, the overlap-save block) are the heuristic
plans'; phase 9 names each mode itself.  The tuning cache is a throwaway file under
``build/`` named through ``REPRO_TUNING_CACHE``.

Phases 3, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16 and 17 each set the launch counts to 0
before they start and read them when they end; every kernel of a path must
have launched in it (phase 12's path has none, and must launch none).  Phases
3–7 and 9 also run every one of their calls over a batch of 0: the output
must have np.fft's shape, and the call launches nothing (0 launches, not
``len(plan.passes)``).  The script then prints the per-kernel JSON line
(each kernel's launches per path, ``hybrid_launches`` phase 12's,
``frontend_launches`` phase 13's, ``distributed_launches`` phase 14's and
``sharded_launches`` phase 15's, ``dryrun_launches`` phase 16's and
``long_launches`` phase 17's, their four ranks' included), the
``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``.  Without a CUDA device it exits
non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import inspect
import json
import math
import multiprocessing
import os
import queue
import re
import socket
import statistics
import subprocess
import sys
import threading
import time
import traceback

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch import kernels  # noqa: E402
from repro_torch.analysis import roofline as rl  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core import conv, fft_torch, overlap, tuning, twiddle  # noqa: E402
from repro_torch.core import distributed as D  # noqa: E402
from repro_torch.core import fft as F  # noqa: E402
from repro_torch.core import plan as plan_lib  # noqa: E402
from repro_torch.core.limits import next_pow2  # noqa: E402
from repro_torch.kernels import bluestein, build, dft_matmul, fft4step, ops, pencil, ref  # noqa: E402
from repro_torch.models.layers.spectral import SpectralMixer, SpectralStreamCache, stream_plan_info  # noqa: E402
from repro_torch.sharding import shard  # noqa: E402
from repro_torch.models.model import DecoderLM  # noqa: E402
from repro_torch.models.stack import find_unit  # noqa: E402
from repro_torch.serving.engine import Engine, PrefillResult, ServeConfig  # noqa: E402
from repro_torch.serving.spectral_serve import ServeSession  # noqa: E402

#: Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W): FP32 on
#: the CUDA cores and HBM3 bandwidth.
FP32_PEAK = 67e12
HBM_BYTES_PER_S = 3.35e12

KERNEL_TOL = 1e-4  # kernel vs its plain version, relative to max|plain|
FFT_TOL = 1e-3  # planned call vs np.fft in complex128, relative to max|ref|

#: (n, batch): complex64 signals of 0.13–1 GB each.  n = 16384 is one
#: 4096-line SAR range block; 2^20 … 2^26 are the two-pass programs.
MAIN_PATH = (
    (1024, 16384),
    (4096, 4096),
    (16384, 4096),
    (65536, 1024),
    (1 << 20, 64),
    (1 << 22, 16),
    (1 << 24, 4),
    (1 << 26, 2),
)

SOURCES = {
    "dft_matmul": ("src/repro_torch/csrc/dft_matmul.cu", "src/repro/kernels/dft_matmul.py:67"),
    "fft4step": ("src/repro_torch/csrc/fft4step.cu", "src/repro/kernels/fft4step.py:114"),
    "cols_pass": ("src/repro_torch/csrc/pencil.cu", "src/repro/kernels/pencil.py:102"),
    "rows_natural": ("src/repro_torch/csrc/pencil.cu", "src/repro/kernels/pencil.py:178"),
    "cols_natural": ("src/repro_torch/csrc/pencil.cu", "src/repro/kernels/pencil.py:234"),
    "rfft_recomb": ("src/repro_torch/csrc/recomb.cu", "src/repro/kernels/pencil.py:313"),
    "irfft_recomb": ("src/repro_torch/csrc/recomb.cu", "src/repro/kernels/pencil.py:324"),
    "bluestein_fwd": ("src/repro_torch/csrc/bluestein.cu", "src/repro/kernels/bluestein.py:85"),
    "bluestein_inv": ("src/repro_torch/csrc/bluestein.cu", "src/repro/kernels/bluestein.py:142"),
    "bluestein_elem": ("src/repro_torch/csrc/bluestein.cu", "src/repro/kernels/bluestein.py:197"),
}

#: The ``__global__`` functions each kernel launches.
FUNCTIONS = {
    "dft_matmul": ("dft_matmul_kernel",),
    "fft4step": ("fft4step_kernel<256, 16>", "fft4step_kernel<512, 16>", "fft4step_kernel<1024, 16>",
                 "fft4step_slab_kernel"),
    "cols_pass": ("cols_radix_kernel<256, 16>", "cols_radix_kernel<512, 16>",
                  "cols_radix_kernel<1024, 16>", "cols_slab_kernel"),
    "rows_natural": ("rows_radix_kernel<256, 16>", "rows_radix_kernel<512, 16>",
                     "rows_radix_kernel<1024, 16>", "rows_slab_kernel"),
    "cols_natural": ("cols_radix_kernel<256, 16, natural>", "cols_radix_kernel<512, 16, natural>",
                     "cols_radix_kernel<1024, 16, natural>", "cols_slab_kernel<natural>"),
    "rfft_recomb": ("rfft_recomb_kernel",),
    "irfft_recomb": ("irfft_recomb_kernel",),
    "bluestein_fwd": ("bluestein_fwd_kernel<256, 16>", "bluestein_fwd_kernel<512, 16>",
                      "bluestein_fwd_kernel<1024, 16>", "bluestein_fwd_slab_kernel"),
    "bluestein_inv": ("bluestein_inv_kernel<256, 16>", "bluestein_inv_kernel<512, 16>",
                      "bluestein_inv_kernel<1024, 16>", "bluestein_inv_slab_kernel"),
    "bluestein_elem": ("bluestein_elem_kernel",),
}

#: This build's ``build.kernel_attributes()``, read once the library loads.
ATTRS: dict = {}

#: The kernels each planned path must launch: phase 3 (1-D complex),
#: phase 5 (real and 2-D), phase 6 (any length), phase 7 (convolution),
#: phase 8 (serving), phase 9 (the tuner), phase 10 (gradients and
#: training), phase 11 (the MoE model served), phase 12 (the recurrent
#: LMs served, which launch none), phase 13 (the frontends served: the
#: spectral musicgen-large's layers), phase 14 (the distributed pencil
#: FFT: its local plans, the 2-D plan's halves, the sharded conv's blocks)
#: phase 15 (sharded training: the mixers' rfft / irfft at 8192, 4096
#: and 2048 points, forward and backward, on every rank) and phase 16 (the
#: real runs beside the dry run: phase 10's step, phase 8's prefill and
#: serving, phase 14 (a)'s transforms, the four ranks' 512-token prompts).
PATH_KERNELS = {
    "main_path": ("dft_matmul", "fft4step", "cols_pass", "rows_natural"),
    "real2d": ("fft4step", "cols_pass", "rows_natural", "cols_natural", "rfft_recomb",
               "irfft_recomb"),
    "bluestein": ("bluestein_fwd", "bluestein_inv", "bluestein_elem", "cols_pass",
                  "rows_natural", "cols_natural", "rfft_recomb", "irfft_recomb"),
    "conv": ("dft_matmul", "fft4step", "cols_pass", "rfft_recomb", "irfft_recomb", "bluestein_fwd",
             "bluestein_inv"),
    "serve": ("dft_matmul", "fft4step", "rfft_recomb", "irfft_recomb"),
    "tune": ("dft_matmul", "fft4step", "cols_pass", "rows_natural", "rfft_recomb", "irfft_recomb",
             "bluestein_fwd", "bluestein_inv", "bluestein_elem"),
    "train": ("dft_matmul", "fft4step", "cols_pass", "rows_natural", "cols_natural", "rfft_recomb",
              "irfft_recomb", "bluestein_fwd", "bluestein_inv", "bluestein_elem"),
    "moe": ("dft_matmul", "fft4step", "rfft_recomb", "irfft_recomb"),
    "hybrid": (),
    "frontend": ("dft_matmul", "fft4step", "rfft_recomb", "irfft_recomb"),
    "distributed": ("fft4step", "cols_pass", "rows_natural"),
    "sharded": ("dft_matmul", "fft4step", "rfft_recomb", "irfft_recomb"),
    "dryrun": ("dft_matmul", "fft4step", "cols_pass", "rows_natural", "rfft_recomb", "irfft_recomb"),
    "long": ("dft_matmul", "rfft_recomb", "irfft_recomb"),
}

#: The kernels phase 14's four ranks must launch between them: the column
#: and row leaves of 2^20 (1024-point: cols_pass, dft_matmul) and 2^24
#: (4096-point: fft4step), the 2-D halves, the sharded conv's rfft / irfft.
PENCIL_RANK_KERNELS = ("dft_matmul", "fft4step", "cols_pass", "rfft_recomb", "irfft_recomb")


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def time_ms(fn, reps: int = 5, warmup: int = 1) -> float:
    """Median over ``reps`` CUDA-event-timed calls, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_PEAK * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(got, want) -> tuple:
    err = max((got[0] - want[0]).abs().max().item(), (got[1] - want[1]).abs().max().item())
    scale = max(want[0].abs().max().item(), want[1].abs().max().item())
    return err, scale


def planes(gen, *shape):
    return (
        torch.randn(*shape, device="cuda", generator=gen),
        torch.randn(*shape, device="cuda", generator=gen),
    )


def fft_flops(f: int) -> float:
    """fp32 flops one length-f FFT needs: 5·f·log2 f.  The same count for
    every kernel, whatever form it computes the transform in (an on-chip
    tile or the slab four-step), so a bound is the function's and not the
    algorithm's."""
    return 5 * f * math.log2(f) if f > 1 else 0.0


def roots_bytes(n: int) -> int:
    """The radix kernels' one LUT: the n roots of unity, two fp32 planes."""
    return 8 * n


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------


def check_kernel(label, call, plain) -> tuple:
    """One kernel call against its plain version on the same inputs, held
    to KERNEL_TOL·max|plain|; returns (max|Δ|, max|plain|)."""
    got = call()
    want = plain()
    torch.cuda.synchronize()
    err, scale = max_err(got, want)
    check(err <= KERNEL_TOL * scale,
          f"{label}: kernel vs plain max|Δ| {err:.3e} > {KERNEL_TOL}·{scale:.3e}")
    return err, scale


def measure_kernel(name, label, call, plain, nbytes, flops, library=None):
    err, scale = check_kernel(label, call, plain)
    ms = time_ms(call)
    plain_ms = time_ms(plain)
    lib_ms = time_ms(library) if library is not None else None
    b_ms, b_by = bound_ms(nbytes, flops)
    row = {
        "name": name, "shape": label, "max_abs_err": err, "rel_err": err / scale,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib_ms,
        "registers": {f: ATTRS[f]["registers"] for f in FUNCTIONS[name]},
        "local_bytes": {f: ATTRS[f]["local_bytes"] for f in FUNCTIONS[name]},
    }
    print("kernel " + json.dumps(row), flush=True)
    return row


def form(kernel: str, f: int) -> str:
    """The form the radix pass takes at length f: its on-chip tile or the
    scratch slab (``pencil.COLS_TILE``, ``ROWS_TILE`` for rows_natural)."""
    table = pencil.ROWS_TILE if kernel == "rows_natural" else pencil.COLS_TILE
    t = table[f.bit_length() - 1]
    return "slab" if t == pencil.SLAB else f"tile 2^{t}"


def pencil_pair(gen, dev, n: int, b: int) -> tuple:
    """The column and row pass of n's two-pass program over (B, n) planes;
    returns their rows."""
    cols, rows_p = plan_lib.plan_fft(n).passes
    x = planes(gen, b, n)
    # Column pass: (B, f0, s) view, inter-factor twiddle epilogue.
    _, s, f = cols.view_in
    w = ops._roots_luts(dev, f, False)
    tw = ops._pass_twiddle_luts(dev, *cols.twiddle_after, False)
    xv = (x[0].view(b, f, s), x[1].view(b, f, s))
    cols_row = measure_kernel(
        "cols_pass", f"n={n} B={b} (R={b}, f={f}, s={s}) {form('cols_pass', f)}",
        lambda: pencil.cols_pass_call(*xv, *w, tw, n1=cols.n1),
        lambda: pencil.cols_pass_plain(*xv, *w, tw),
        nbytes=16 * b * n + 8 * f * s + roots_bytes(f),
        flops=b * s * fft_flops(f) + 6 * b * n,
    )
    # No torch call computes the pass with its twiddle; without it, the
    # column FFT is one torch.fft call: the pass's yardstick beside it.
    xc = torch.complex(*xv)
    cols_row["library_without_twiddle_ms"] = time_ms(lambda: torch.fft.fft(xc, dim=-2))
    print("library_without_twiddle " + json.dumps({"shape": cols_row["shape"],
                                                   "ms": cols_row["library_without_twiddle_ms"]}),
          flush=True)
    del xc
    # Row pass: (B, p, f) → (B, f, p) transposed write.
    p_, _, f = rows_p.view_in
    w = ops._roots_luts(dev, f, False)
    xv = (x[0].view(b, p_, f), x[1].view(b, p_, f))
    rows_row = measure_kernel(
        "rows_natural", f"n={n} B={b} (B={b}, p={p_}, f={f}) {form('rows_natural', f)}",
        lambda: pencil.rows_natural_call(*xv, *w, n1=rows_p.n1),
        lambda: pencil.rows_natural_plain(*xv, *w),
        nbytes=16 * b * n + roots_bytes(f),
        flops=b * p_ * fft_flops(f),
    )
    del x, xv
    torch.cuda.empty_cache()
    return cols_row, rows_row


def kernel_phase(gen) -> dict:
    """Every kernel at main-path shapes; returns its representative row."""
    dev = ops.device_key("cuda")
    rows = {}

    # 1. dft_matmul: the n = 1024 direct leaf, forward and inverse.
    n, b = 1024, 16384
    x = planes(gen, b, n)
    xc = torch.complex(*x)
    for inverse in (False, True):
        w = ops._roots_luts(dev, n, inverse)
        row = measure_kernel(
            "dft_matmul", f"B={b} N={n}" + (" inverse" if inverse else ""),
            lambda: dft_matmul.dft_matmul_call(*x, *w, inverse=inverse),
            lambda: dft_matmul.dft_matmul_plain(*x, *w, inverse=inverse),
            nbytes=16 * b * n + roots_bytes(n), flops=b * fft_flops(n),
            library=lambda: (torch.fft.ifft if inverse else torch.fft.fft)(xc),
        )
        rows.setdefault("dft_matmul", row)
    del x, xc

    # 2. fft4step: its slab decision's shared memory is the library's, then
    # the whole-signal leaves, natural and k1-major order, the inverse
    # through the slab, and the lengths phase 5 gives them (the
    # 8192-point child of rfft 16384, the 2048-point rows of fft2
    # (131072, 2048)).
    smem = build.function("repro_fft4step_smem_bytes", (build.I64,), build.I64)
    for n in (1 << k for k in range(1, 25)):
        check(fft4step.smem_bytes(n) == smem(n), f"fft4step.smem_bytes({n}) {fft4step.smem_bytes(n)}, "
                                                 f"the library's {smem(n)}")
    for n, b, orders in ((4096, 4096, (True, False)), (16384, 4096, (True, False)),
                         (65536, 1024, (True, False, "inverse")), (8192, 8192, (True,)),
                         (2048, 131072, (True,))):
        x = planes(gen, b, n)
        n1, n2 = plan_lib.balanced_split(n)
        xc = torch.complex(*x)
        for order in orders:
            inverse = order == "inverse"
            natural = order is not False
            w = ops._roots_luts(dev, n, inverse)
            kw = dict(n1=n1, inverse=inverse, natural_order=natural)
            label = "inverse" if inverse else "natural" if natural else "k1-major"
            lib = (torch.fft.ifft if inverse else torch.fft.fft) if natural else None
            row = measure_kernel(
                "fft4step", f"B={b} n={n} ({n1}x{n2}) {label}",
                lambda: fft4step.fft4step_call(*x, *w, **kw),
                lambda: fft4step.fft4step_plain(*x, *w, **kw),
                nbytes=16 * b * n + roots_bytes(n), flops=b * fft_flops(n),
                library=(lambda: lib(xc)) if lib is not None else None,
            )
            if n == 16384 and natural:
                rows["fft4step"] = row
        del x, xc
    torch.cuda.empty_cache()

    # 3./4. the pencil passes of each two-pass main-path program, and of
    # the pad length 2^18 that phase 6's split regime runs for n = 100003.
    for n, b in MAIN_PATH + ((1 << 18, 64),):
        if len(plan_lib.plan_fft(n).passes) != 2:
            continue
        pair = pencil_pair(gen, dev, n, b)
        if n == 1 << 22:
            rows["cols_pass"], rows["rows_natural"] = pair
    rows.update(real2d_kernels(gen, dev))
    rows.update(bluestein_kernels(gen, dev))
    return rows


def recomb_flops(points: int) -> int:
    """fp32 flops of the recombination: per output element 4 sums and 4
    halvings of E and O, 6 for w·O and 2 for the final add."""
    return 16 * points


def strip_mined_columns(gen, dev, n: int, n2: int) -> dict:
    """The two column factors of an (n2, n) image's strip-mined columns:
    the strided factor with its twiddle broadcast over runs of n columns
    (``tw_every = n``), then the digit-transposing last factor; returns the
    last factor's row."""
    strided, last = plan_lib.plan_fft2(n, n2).passes[-2:]
    _, stride, f = strided.view_in
    x = planes(gen, 1, f, stride * n)
    w = ops._roots_luts(dev, f, False)
    tw = ops._pass_twiddle_luts(dev, *strided.twiddle_after, False)
    measure_kernel(
        "cols_pass", f"fft2 {n2}x{n} strided factor (R=1, f={f}, s={stride}x{n}) "
        f"{form('cols_pass', f)} tw_every={n}",
        lambda: pencil.cols_pass_call(*x, *w, tw, n1=strided.n1, tw_every=n),
        lambda: pencil.cols_pass_plain(*x, *w, tw, tw_every=n),
        nbytes=16 * n * n2 + 8 * f * stride + roots_bytes(f),
        flops=stride * n * fft_flops(f) + 6 * n * n2,
    )
    del x
    pencils, _, f = last.view_in
    row = natural_columns(gen, dev, f"fft2 {n2}x{n} last factor", pencils, f, n, last.n1)
    torch.cuda.empty_cache()
    return row


def natural_columns(gen, dev, label: str, pp: int, f: int, w: int, n1: int = 0) -> dict:
    """``cols_natural`` on one (1, P, f, w) input against its plain version;
    returns its row."""
    x = planes(gen, 1, pp, f, w)
    rr = ops._roots_luts(dev, f, False)
    row = measure_kernel(
        "cols_natural", f"{label} (B=1, P={pp}, f={f}, w={w}) {form('cols_natural', f)}".lstrip(),
        lambda: pencil.cols_natural_call(*x, *rr, n1=n1),
        lambda: pencil.cols_natural_plain(*x, *rr),
        nbytes=16 * pp * f * w + roots_bytes(f),
        flops=pp * w * fft_flops(f),
    )
    del x
    return row


def real2d_kernels(gen, dev) -> dict:
    """The kernels of the real and 2-D path at the shapes phases 5 and 6
    give them (and cols_natural's 2^14 tile and slab forms, which no
    phase-5 shape reaches at a size that fits the time limit)."""
    rows = {}
    # rfft2 of a 16384 x 16384 image: 16384 rows of m = 8192 packed bins;
    # rfft of 6000-sample lines: 8192 rows of m = 3000.
    for b, m in ((16384, 8192), (8192, 3000)):
        z = planes(gen, b, m)
        w = ops.recomb_luts(dev, 2 * m, False)
        row = measure_kernel(
            "rfft_recomb", f"B={b} m={m}",
            lambda: pencil.rfft_recomb_call(*z, *w),
            lambda: pencil.rfft_recomb_plain(*z, *w),
            nbytes=8 * b * m + 8 * b * (m + 1) + 8 * (m + 1), flops=recomb_flops(b * (m + 1)),
        )
        rows.setdefault("rfft_recomb", row)
        del z
        x = planes(gen, b, m + 1)
        w = ops.recomb_luts(dev, 2 * m, True)
        row = measure_kernel(
            "irfft_recomb", f"B={b} m={m}",
            lambda: pencil.irfft_recomb_call(*x, *w),
            lambda: pencil.irfft_recomb_plain(*x, *w),
            nbytes=8 * b * (m + 1) + 8 * b * m + 8 * (m + 1), flops=recomb_flops(b * m),
        )
        rows.setdefault("irfft_recomb", row)
        del x

    # The strip-mined columns of (131072, w) images: w = 2048, and w = 500
    # (phase 6) with its twiddle's division by the width.
    rows["cols_natural"] = strip_mined_columns(gen, dev, 2048, 1 << 17)
    strip_mined_columns(gen, dev, 500, 1 << 17)
    # cols_natural's other forms: the 2^14 tile (f = 2048, 8 columns a
    # block) and the slab four-step (f = 4096), 0.5 GB each.
    for pp, f, w in ((2048, 2048, 32), (256, 4096, 64)):
        natural_columns(gen, dev, "", pp, f, w, plan_lib.balanced_split(f)[0])

    # The whole columns of rfft2's 16384 x 16384 image over its m + 1 = 8193
    # bins (a ragged width), beside the width 8192 that has no ragged chunk,
    # of the azimuth pass fft axis=-2 (16384, 4096) and of phase 6's
    # (4096, 3000) image: no twiddle, so one torch.fft call computes them.
    for call, f, s_ in (("rfft2", 16384, 8193), ("rfft2", 16384, 8192),
                        ("fft axis=-2", 16384, 4096), ("fft2", 4096, 3000)):
        r = 1
        w = ops._roots_luts(dev, f, False)
        x = planes(gen, r, f, s_)
        xc = torch.complex(*x)
        measure_kernel(
            "cols_pass", f"{call} columns (R={r}, f={f}, s={s_}) {form('cols_pass', f)}"
            + (" ragged" if s_ % pencil.SLAB_GROUP else ""),
            lambda: pencil.cols_pass_call(*x, *w),
            lambda: pencil.cols_pass_plain(*x, *w),
            nbytes=16 * r * f * s_ + roots_bytes(f),
            flops=r * s_ * fft_flops(f),
            library=lambda: torch.fft.fft(xc, dim=-2),
        )
        del x, xc
    torch.cuda.empty_cache()
    return rows


def bluestein_flops(stage: str, n: int, m: int) -> float:
    """fp32 flops one signal's fused Bluestein stage needs: the M-point FFT
    (5·M·log2 M) and 6 per phasor multiply, the chirp and B̂ (forward) or
    the post-chirp (inverse)."""
    if stage == "fwd":
        return 6 * n + fft_flops(m) + 6 * m
    return fft_flops(m) + 6 * n


#: Phase 2's shapes of the fused Bluestein stages: (batch, n), every one
#: that phase 6 gives them (the rows of its fft2 and axis=-2 calls too).
BLUESTEIN_FUSED = ((16384, 500), (131072, 500), (8192, 3000), (4096, 3000), (2048, 12288),
                   (8192, 4999))


def bluestein_form(x, m: int, in1: int) -> str:
    """The form a fused Bluestein stage takes at pad m on this card: its
    whole-signal tile or the slab four-step (``bluestein.slab_split``)."""
    n1 = bluestein.slab_split(x, m, in1)
    return f"slab {n1}x{m // n1}" if n1 else f"tile 2^{max(12, m.bit_length() - 1)}"


def elem_bytes(b: int, w_in: int, w_out: int, w_lut: int) -> int:
    """The bytes a ``bluestein_elem`` stage must move: every output, the
    LUT, and the inputs it keeps (``pre`` reads n and writes the M-point
    pad, ``mul`` M each way, ``post`` reads only the n bins it keeps of M)."""
    return 8 * b * (min(w_in, w_out) + w_out) + 8 * w_lut


def bluestein_kernels(gen, dev) -> dict:
    """The three Bluestein kernels at the shapes phase 6 gives them: the
    fused stages in the 4096-point tile (M = 1024), the 8192- and
    16384-point tiles (M = 8192, 16384) and the slab four-step (M = 32768),
    and the split regime's elementwise stages at n = 100003 (M = 2^18).
    Bound: the stage's own bytes (x in, y out, the chirp tables and the
    pad's roots table once each) and flops."""
    rows = {}
    for b, n in BLUESTEIN_FUSED:
        fwd, inv = plan_lib.plan_fft(n).passes
        m = fwd.n1
        kw = dict(n=n, m_pad=m)
        in1 = plan_lib._leaf_pass(m).n1
        for stage, p, width in (("fwd", fwd, n), ("inv", inv, m)):
            luts = ops._bluestein_luts(dev, p, False)
            x = planes(gen, b, width)
            call = getattr(bluestein, f"bluestein_{stage}_call")
            plain = getattr(bluestein, f"bluestein_{stage}_plain")
            row = measure_kernel(
                f"bluestein_{stage}", f"B={b} n={n} M={m} {bluestein_form(x[0], m, in1)}",
                lambda: call(*x, luts, in1=in1, **kw), lambda: plain(*x, luts, **kw),
                nbytes=8 * b * (n + m) + sum(4 * t.numel() for t in luts),
                flops=b * bluestein_flops(stage, n, m),
            )
            if n == 3000:
                rows[f"bluestein_{stage}"] = row
            del x
    b, n = 64, 100003
    m = plan_lib.bluestein_pad(n)
    for stage in bluestein.STAGES:
        w_in, w_out, w_lut = bluestein._elem_widths(stage, n, m)
        p = plan_lib.Pass(kind="bluestein", n=n, n1=m, stage=stage)
        lut = ops._bluestein_luts(dev, p, False)
        x = planes(gen, b, w_in)
        kw = dict(stage=stage, n=n, m_pad=m)
        row = measure_kernel(
            "bluestein_elem", f"{stage} B={b} n={n} M={m}",
            lambda: bluestein.bluestein_elem_call(*x, lut, **kw),
            lambda: bluestein.bluestein_elem_plain(*x, lut, **kw),
            nbytes=elem_bytes(b, w_in, w_out, w_lut), flops=6 * b * min(w_in, w_out),
        )
        if stage == "mul":
            rows["bluestein_elem"] = row
        del x
    torch.cuda.empty_cache()
    return rows


def register_guard() -> None:
    """Print every ``__global__`` function's registers and local bytes per
    thread beside the recorded build's; fail where ``build.attribute_faults``
    finds a fault (more local bytes than recorded)."""
    for name, row in sorted(ATTRS.items()):
        was = build.RECORDED_ATTRS.get(name)
        print("registers " + json.dumps({
            "function": name, **row, "recorded": None if was is None else list(was),
        }), flush=True)
    faults = build.attribute_faults(ATTRS)
    check(not faults, "register guard: " + "; ".join(faults))


# ---------------------------------------------------------------------------
# phase 3: the planned main path
# ---------------------------------------------------------------------------


def check_launches(label: str, before: dict, after: dict, expect: dict) -> None:
    """Every counter moved by exactly ``expect`` (kernel → launches) from
    ``before`` to ``after``; plain versions and other kernels by 0."""
    for key in after:
        delta = after[key] - before[key]
        want = 0 if key.endswith("_plain") else expect.get(key, 0)
        check(delta == want, f"{label}: {key} moved by {delta}, expected {want}")


def launches_per_call(planned, calls: int = 1) -> dict:
    expect = {}
    for k in planned.kernels:
        expect[k] = expect.get(k, 0) + calls
    return expect


def counted_call(label: str, planned, x):
    """One planned call, held to exactly ``len(planned.passes)`` launches;
    returns its output and the bytes the call held on the card beyond what
    was allocated before it (output included)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    before = kernels.counts()
    y = planned(x)
    torch.cuda.synchronize()
    check_launches(label, before, kernels.counts(), launches_per_call(planned))
    return y, torch.cuda.max_memory_allocated() - base


def empty_call(label: str, fwd, inv, shape) -> None:
    """The forward call over a batch of 0 (``shape``: its input's), then the
    inverse over what it returned: np.fft's shape, the input's shape back,
    and no kernel launched (an empty call launches 0, not len(passes))."""
    x = np.zeros(shape, np.float32 if fwd.spec.kind.startswith("rfft") else np.complex64)
    before = kernels.counts()
    y = fwd(torch.from_numpy(x).cuda())
    z = inv(y)
    torch.cuda.synchronize()
    check_launches(f"{label} empty batch", before, kernels.counts(), {})
    got = tuple(as_complex(y).shape)
    want = ref.np_fft(fwd.spec, x).shape
    check(got == want, f"{label} empty batch: forward gives {got}, np.fft {want}")
    check(tuple(z.shape) == shape, f"{label} empty batch: inverse gives {tuple(z.shape)}")


def main_path_phase(gen) -> None:
    reps, warmup = 3, 1
    for n, b in MAIN_PATH:
        fwd = F.plan(F.FFTSpec(n))
        inv = F.plan(F.FFTSpec(n, kind="ifft"))
        check(fwd.device.type == "cuda" and fwd.backend.name == "cuda", f"n={n}: plan is not on the card")
        x = torch.complex(*planes(gen, b, n))
        at_start = kernels.counts()

        y, peak = counted_call(f"n={n} fft", fwd, x)
        check(tuple(y.shape) == (b, n) and y.dtype == torch.complex64, f"n={n}: output {y.shape} {y.dtype}")
        check(bool(torch.isfinite(torch.view_as_real(y)).all()), f"n={n}: non-finite output")

        sample = sorted({0, b - 1})
        ref = np.fft.fft(x[sample].cpu().numpy().astype(np.complex128), axis=-1)
        err = np.abs(y[sample].cpu().numpy() - ref).max()
        scale = np.abs(ref).max()
        check(err <= FFT_TOL * scale, f"n={n}: fft vs np.fft {err:.3e} > {FFT_TOL}·{scale:.3e}")

        z, _ = counted_call(f"n={n} ifft", inv, y)
        rt = (z - x).abs().max().item()
        xs = x.abs().max().item()
        check(rt <= FFT_TOL * xs, f"n={n}: ifft(fft(x)) off by {rt:.3e} > {FFT_TOL}·{xs:.3e}")
        del y, z

        fwd_ms = time_ms(lambda: fwd(x), reps=reps, warmup=warmup)
        inv_ms = time_ms(lambda: inv(x), reps=reps, warmup=warmup)
        # Every call of this shape, checked and timed, launched its plan's
        # kernels and nothing else.
        expect = launches_per_call(fwd, 1 + warmup + reps)
        for k, c in launches_per_call(inv, 1 + warmup + reps).items():
            expect[k] = expect.get(k, 0) + c
        check_launches(f"n={n} all calls", at_start, kernels.counts(), expect)
        lib_ms = time_ms(lambda: torch.fft.fft(x), reps=reps, warmup=warmup)  # the yardstick only
        print(
            "main_path " + json.dumps({
                "n": n, "batch": b, "passes": len(fwd.passes), "kernels": list(fwd.kernels),
                "fft_rel_err": float(err / scale), "roundtrip_rel_err": rt / xs,
                "fft_ms": fwd_ms, "ifft_ms": inv_ms, "library_ms": lib_ms,
                "input_bytes": x.numel() * x.element_size(), "fft_call_peak_bytes": peak,
            }),
            flush=True,
        )
        del x
        torch.cuda.empty_cache()
        empty_call(f"n={n}", fwd, inv, (0, n))


# ---------------------------------------------------------------------------
# phase 4: offsets past 2^31
# ---------------------------------------------------------------------------

#: (n, batch) with batch·n just past 2^31 elements per plane, so every
#: kernel addresses beyond a 32-bit offset: the fused leaf with its scratch
#: slab, and both pencil passes of a direct-leaf program.
BIG_OFFSETS = ((65536, 32769), (1 << 20, 2049))


def offsets_phase(gen) -> None:
    for n, b in BIG_OFFSETS:
        planned = F.plan(F.FFTSpec(n))
        xr, xi = planes(gen, b, n)  # planes in, planes out: 8 GB each
        (yr, yi), peak = counted_call(f"n={n} B={b}", planned, (xr, xi))
        sample = [0, b // 2, b - 1]
        x = (xr[sample].double() + 1j * xi[sample].double()).cpu().numpy()
        ref = np.fft.fft(x, axis=-1)
        got = (yr[sample].double() + 1j * yi[sample].double()).cpu().numpy()
        err = np.abs(got - ref).max()
        scale = np.abs(ref).max()
        check(err <= FFT_TOL * scale, f"n={n} B={b}: rows past 2^31 off by {err:.3e}")
        print("offsets " + json.dumps({
            "n": n, "batch": b, "elements_per_plane": b * n, "kernels": list(planned.kernels),
            "fft_rel_err": float(err / scale),
            "input_bytes": 8 * b * n, "call_peak_bytes": peak,
        }), flush=True)
        del xr, xi, yr, yi
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 5: the real and 2-D path
# ---------------------------------------------------------------------------

#: (forward spec, inverse spec, input shape): 0.5–2 GB each.  rfft at 16384
#: points is one SAR range line block; 2^21 takes the two-pass inner
#: program; the 16384² image is one spotlight scene; the 131072-line image
#: strip-mines its columns; axis=-2 is the azimuth pass of a range block.
REAL_2D = (
    (F.FFTSpec(16384, kind="rfft"), F.FFTSpec(16384, kind="irfft"), (8192, 16384)),
    (F.FFTSpec(1 << 21, kind="rfft"), F.FFTSpec(1 << 21, kind="irfft"), (64, 1 << 21)),
    (F.FFTSpec(16384, kind="fft2", n2=16384), F.FFTSpec(16384, kind="ifft2", n2=16384),
     (1, 16384, 16384)),
    (F.FFTSpec(2048, kind="fft2", n2=1 << 17), F.FFTSpec(2048, kind="ifft2", n2=1 << 17),
     (1, 1 << 17, 2048)),
    (F.FFTSpec(16384, kind="rfft2", n2=16384), F.FFTSpec(16384, kind="irfft2", n2=16384),
     (1, 16384, 16384)),
    (F.FFTSpec(16384, axis=-2), F.FFTSpec(16384, kind="ifft", axis=-2), (16384, 4096)),
)


def as_complex(y):
    return torch.complex(*y) if isinstance(y, tuple) else y


def row_dft(x, ks, n: int) -> np.ndarray:
    """Σ_j x[r, j]·e^{−2πi·j·k/n} for each row r and sample frequency k, in
    complex128 on the card: the rows' DFT at ``ks`` only, (rows, len(ks))."""
    j = torch.arange(n, device=x.device, dtype=torch.int64)
    phase = torch.outer(j, torch.tensor(ks, device=x.device, dtype=torch.int64)) % n
    ang = phase.to(torch.float64) * (-2 * math.pi / n)
    w = torch.polar(torch.ones_like(ang), ang)
    out = [x[r:r + 1024].to(torch.complex128) @ w for r in range(0, x.shape[0], 1024)]
    return torch.cat(out).cpu().numpy()


def sample_check(spec, x, y) -> float:
    """The forward output at sample rows (1-D) or columns (2-D, axis=-2)
    against np.fft in complex128; returns max|Δ| / max|ref|."""
    if spec.kind == "rfft":
        rows = [0, x.shape[0] - 1]
        ref = np.fft.rfft(x[rows].double().cpu().numpy(), axis=-1)
        got = as_complex(y)[rows]
    elif spec.kind == "fft" and spec.axis == -1:
        rows = [0, x.shape[0] - 1]
        ref = np.fft.fft(x[rows].cpu().numpy().astype(np.complex128), axis=-1)
        got = y[rows]
    elif spec.axis == -2:
        cols = [0, 1, x.shape[-1] - 1]
        ref = np.fft.fft(x[:, cols].cpu().numpy().astype(np.complex128), axis=0)
        got = y[:, cols]
    else:
        # Column k of fft2/rfft2 is the column FFT of the rows' DFT at k.
        n = spec.n
        ks = [0, 1, 3 * n // 8 + 1, n // 2] + ([n - 1] if spec.kind == "fft2" else [])
        ref = np.fft.fft(row_dft(x[0], ks, n), axis=0)
        got = as_complex(y)[0][:, ks]
    err = np.abs(got.cpu().numpy().astype(np.complex128) - ref).max()
    return float(err / np.abs(ref).max())


#: Phase 6, arbitrary lengths at SAR sizes (0.06–1 GB each): a 500-sample
#: range line (M = 1024, direct inner), 3000 (M = 8192, four-step in shared
#: memory), 12288 = 3·2^12 (M = 32768, scratch slab), an azimuth aperture of
#: 100003 (M = 2^18, the split regime's seven passes), odd and even real
#: lines, images with Bluestein rows and whole or strip-mined columns
#: (tw_every = 500), and an azimuth pass of 3000 down axis -2.
ANY_LENGTH = (
    (F.FFTSpec(500), F.FFTSpec(500, kind="ifft"), (16384, 500)),
    (F.FFTSpec(3000), F.FFTSpec(3000, kind="ifft"), (8192, 3000)),
    (F.FFTSpec(12288), F.FFTSpec(12288, kind="ifft"), (2048, 12288)),
    (F.FFTSpec(100003), F.FFTSpec(100003, kind="ifft"), (64, 100003)),
    (F.FFTSpec(4999, kind="rfft"), F.FFTSpec(4999, kind="irfft"), (8192, 4999)),
    (F.FFTSpec(6000, kind="rfft"), F.FFTSpec(6000, kind="irfft"), (8192, 6000)),
    (F.FFTSpec(3000, kind="fft2", n2=4096), F.FFTSpec(3000, kind="ifft2", n2=4096),
     (1, 4096, 3000)),
    (F.FFTSpec(500, kind="fft2", n2=1 << 17), F.FFTSpec(500, kind="ifft2", n2=1 << 17),
     (1, 1 << 17, 500)),
    (F.FFTSpec(3000, axis=-2), F.FFTSpec(3000, kind="ifft", axis=-2), (3000, 4096)),
)


def library_call(spec):
    """The one ``torch.fft`` call computing ``spec``'s transform: the
    yardstick only, never used by the port."""
    n, ax = spec.n, spec.axis
    return {
        "fft": lambda x: torch.fft.fft(x, dim=ax),
        "ifft": lambda x: torch.fft.ifft(x, dim=ax),
        "rfft": lambda x: torch.fft.rfft(x, dim=ax),
        "irfft": lambda x: torch.fft.irfft(x, n=n, dim=ax),
        "fft2": torch.fft.fft2,
        "ifft2": torch.fft.ifft2,
        "rfft2": torch.fft.rfft2,
        "irfft2": lambda x: torch.fft.irfft2(x, s=(x.shape[-2], n)),
    }[spec.kind]


def calls_phase(gen, cases, tag: str) -> None:
    """Each (forward, inverse, input shape) case: the forward against np.fft
    at sample rows or columns, the inverse back to the input, exactly
    ``len(passes)`` launches in every call, times beside ``torch.fft``."""
    reps, warmup = 3, 1
    for fspec, ispec, shape in cases:
        fwd, inv = F.plan(fspec), F.plan(ispec)
        label = f"{fspec.kind} {'x'.join(map(str, shape))}" + (" axis=-2" if fspec.axis == -2 else "")
        check(fwd.device.type == "cuda" and inv.device.type == "cuda", f"{label}: plan is not on the card")
        if fspec.kind.startswith("r"):
            x = torch.randn(*shape, device="cuda", generator=gen)
        else:
            x = torch.complex(*planes(gen, *shape))
        at_start = kernels.counts()

        y, peak = counted_call(f"{label} forward", fwd, x)
        yc = as_complex(y)
        check(bool(torch.isfinite(torch.view_as_real(yc)).all()), f"{label}: non-finite output")
        err = sample_check(fspec, x, y)
        check(err <= FFT_TOL, f"{label}: vs np.fft {err:.3e} > {FFT_TOL}·max|ref|")
        z, _ = counted_call(f"{label} inverse", inv, y)
        rt = (z - x).abs().max().item()
        xs = x.abs().max().item()
        check(tuple(z.shape) == tuple(x.shape), f"{label}: inverse gives {tuple(z.shape)}")
        check(rt <= FFT_TOL * xs, f"{label}: inverse off by {rt:.3e} > {FFT_TOL}·{xs:.3e}")
        del z

        fwd_ms = time_ms(lambda: fwd(x), reps=reps, warmup=warmup)
        inv_ms = time_ms(lambda: inv(y), reps=reps, warmup=warmup)
        expect = launches_per_call(fwd, 1 + warmup + reps)
        for k, c in launches_per_call(inv, 1 + warmup + reps).items():
            expect[k] = expect.get(k, 0) + c
        check_launches(f"{label} all calls", at_start, kernels.counts(), expect)
        lib_fwd, lib_inv = library_call(fspec), library_call(ispec)
        lib_fwd_ms = time_ms(lambda: lib_fwd(x), reps=reps, warmup=warmup)
        lib_inv_ms = time_ms(lambda: lib_inv(yc), reps=reps, warmup=warmup)
        print(
            f"{tag} " + json.dumps({
                "call": label, "inverse": ispec.kind, "passes": len(fwd.passes),
                "kernels": list(fwd.kernels), "inverse_kernels": list(inv.kernels),
                "rel_err": err, "roundtrip_rel_err": rt / xs,
                "ms": fwd_ms, "inverse_ms": inv_ms,
                "library_ms": lib_fwd_ms, "library_inverse_ms": lib_inv_ms,
                "input_bytes": x.numel() * x.element_size(), "call_peak_bytes": peak,
            }),
            flush=True,
        )
        del x, y, yc
        torch.cuda.empty_cache()
        empty_call(label, fwd, inv, (0,) + (shape if fspec.axis == -2 else shape[1:]))


# ---------------------------------------------------------------------------
# phase 7: the convolution layer and the spectral mixer
# ---------------------------------------------------------------------------

#: The kernels' ``__global__`` names, as a profiler trace shows them.
OUR_KERNEL = re.compile(
    r"\b(" + "|".join(sorted({f.split("<")[0] for fs in FUNCTIONS.values() for f in fs})) + r")\b"
)


def device_split(fn):
    """(kernel ms, other device ms, {kernel name: ms} of the other's eight
    largest) of one call of ``fn`` from a ``torch.profiler`` trace: the
    port's kernels by name, every other device activity (torch's elementwise
    kernels, copies, fills, GEMMs) by the profiler's raw name; None when the
    trace holds no device time.  A failure of the call itself propagates."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ours, others = 0.0, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            if OUR_KERNEL.search(e.name):
                ours += us
            else:
                others[e.name] = others.get(e.name, 0.0) + us / 1e3
    other = sum(others.values())
    top = dict(sorted(others.items(), key=lambda kv: -kv[1])[:8])
    return (ours / 1e3, other, top) if ours or other else None


#: Device activity of a training step by class, from the profiler's raw
#: names: cuBLAS / CUTLASS matrix products, the attention's masked softmax,
#: copies and dtype casts, and every other elementwise or reduction kernel.
DEVICE_CLASSES = (
    ("gemm", re.compile(r"gemm|nvjet|cutlass|xmma|sm90_", re.I)),
    ("softmax_mask", re.compile(r"softmax|masked_fill", re.I)),
    ("copy_cast", re.compile(r"copy|memcpy|memset|cat", re.I)),
)


def device_classes(fn):
    """ms of each device class (and the port's kernels as ``fft_kernels``)
    in one call of ``fn``, by ``torch.profiler``; None without device
    time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {"fft_kernels": 0.0, **{name: 0.0 for name, _ in DEVICE_CLASSES}, "other": 0.0}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = e.time_range.elapsed_us() / 1e3
        if OUR_KERNEL.search(e.name):
            out["fft_kernels"] += ms
            continue
        out[next((name for name, pat in DEVICE_CLASSES if pat.search(e.name)), "other")] += ms
    return out if any(out.values()) else None


def conv_ref(x: np.ndarray, h: np.ndarray, length: int) -> np.ndarray:
    """The first ``length`` samples of the linear convolution of each row of
    ``x`` with ``h`` (broadcast over rows), by ``np.fft`` in complex128."""
    x, h = np.asarray(x, np.float64), np.asarray(h, np.float64)
    n = next_pow2(x.shape[-1] + h.shape[-1] - 1)
    return np.fft.irfft(np.fft.rfft(x, n) * np.fft.rfft(h, n), n)[..., :length]


def rows_err(got, x, h, rows, length: int) -> float:
    """max|Δ| / max|ref| of ``got``'s sample ``rows`` against :func:`conv_ref`."""
    ref = conv_ref(x[rows].cpu().numpy(), h.cpu().numpy(), length)
    return float(np.abs(got[rows].double().cpu().numpy() - ref).max() / np.abs(ref).max())


def lib_conv(x, h, n: int, length: int):
    """The same causal convolution along the last axis through
    ``torch.fft.rfft``/``irfft``: the library yardstick in float32, and in
    float64 the full reference every output is held against."""
    y = torch.fft.irfft(torch.fft.rfft(x, n=n) * torch.fft.rfft(h, n=n), n=n)
    return y[..., :length]


def full_err(got, ref) -> float:
    """max|Δ| / max|ref| over every element, ``ref`` in float64."""
    return ((got.double() - ref).abs().max() / ref.abs().max()).item()


def plans_launches(uses) -> dict:
    """Kernel → launches of the plans in ``uses`` ((spec, calls) pairs), each
    call ``len(plan.passes)`` launches: what a conv over them must run."""
    expect = {}
    for spec, calls in uses:
        for k, c in launches_per_call(F.plan(spec), calls).items():
            expect[k] = expect.get(k, 0) + c
    return expect


def rplans(n: int, n2=None, calls: tuple = (2, 1)) -> list:
    """The (spec, calls) pairs of a conv at length n: the real forward plan
    ``calls[0]`` times (signal and filter), the inverse ``calls[1]``."""
    fwd, inv = ("rfft2", "irfft2") if n2 else ("rfft", "irfft")
    return [(F.FFTSpec(n, kind=fwd, n2=n2), calls[0]), (F.FFTSpec(n, kind=inv, n2=n2), calls[1])]


def held_call(label: str, fn, expect: dict):
    """One call held to exactly ``expect``'s launches; returns its output and
    the device bytes it held beyond what was allocated before it."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    before = kernels.counts()
    y = fn()
    torch.cuda.synchronize()
    check_launches(label, before, kernels.counts(), expect)
    return y, torch.cuda.max_memory_allocated() - base


def conv_case(label: str, run, x, h, expect: dict, lib, rows_err_of, empty, empty_shape, **extra):
    """Phase 7's rule for one call: ``run(x)`` held to ``expect`` launches;
    every output within FFT_TOL of the full float64 reference ``lib(x, h)``
    in float64 on the card, and ``rows_err_of(y)`` (sample rows against
    ``np.fft`` in complex128, a second witness) too; every timed call
    launching the same; the ``torch.fft`` yardstick ``lib(x, h)`` in float32
    timed beside it; and the batch of 0.  Returns the output."""
    reps, warmup = 3, 1
    at_start = kernels.counts()
    y, peak = held_call(label, lambda: run(x), expect)
    check(bool(torch.isfinite(y).all()), f"{label}: non-finite output")
    ref = lib(x.double(), h.double())
    err = full_err(y, ref)
    del ref
    check(err <= FFT_TOL, f"{label}: vs the float64 reference {err:.3e} > {FFT_TOL}·max|ref|")
    rows = rows_err_of(y)
    check(rows <= FFT_TOL, f"{label}: sample rows vs np.fft {rows:.3e} > {FFT_TOL}·max|ref|")
    ms = time_ms(lambda: run(x), reps=reps, warmup=warmup)
    check_launches(f"{label} all calls", at_start, kernels.counts(),
                   {k: v * (1 + warmup + reps) for k, v in expect.items()})
    split = device_split(lambda: run(x))
    lib_ms = time_ms(lambda: lib(x, h), reps=reps, warmup=warmup)
    print("conv " + json.dumps({
        "call": label, "launches": sum(expect.values()), "kernels": expect, "rel_err": err,
        "rows_rel_err": rows, "ms": ms, "library_ms": lib_ms,
        "kernel_ms": split[0] if split else None, "other_device_ms": split[1] if split else None,
        "other_top": split[2] if split else None,
        "outside_kernels": (ms - split[0]) / ms if split else None,
        "input_bytes": x.numel() * x.element_size(), "call_peak_bytes": peak, **extra,
    }), flush=True)
    before = kernels.counts()
    z = run(empty)
    torch.cuda.synchronize()
    check_launches(f"{label} empty batch", before, kernels.counts(), {})
    check(tuple(z.shape) == empty_shape, f"{label} empty batch: {tuple(z.shape)}, expected {empty_shape}")
    return y


def conv_phase(gen) -> None:
    """Calls (a)–(f): the conv layer at full size."""
    def randn(*shape, scale=1.0):
        return scale * torch.randn(*shape, device="cuda", generator=gen)

    # (a) Spectral prefill at h2o-danube-1.8b's width: (1, 32768, 2560) along
    # the sequence axis, per-channel 1024-tap filters; n = 65536.
    S, D, LF = 32768, 2560, 1024
    u, filt = randn(1, S, D), randn(D, LF, scale=LF**-0.5)
    n = next_pow2(S + LF - 1)
    ch = [0, D // 2, D - 1]
    conv_case(
        "(a) fft_conv (1, 32768, 2560) axis=1 per-channel (2560, 1024)",
        lambda v: conv.fft_conv(v, filt, axis=1), u, filt, plans_launches(rplans(n)),
        lambda v, f: torch.fft.irfft(torch.fft.rfft(v, n=n, dim=1) * torch.fft.rfft(f.T, n=n, dim=0),
                                     n=n, dim=1)[:, :S],
        lambda y: rows_err(y[0].T, u[0].T, filt[ch], ch, S),
        u[:0], (0, S, D), n=n,
    )
    del u, filt
    torch.cuda.empty_cache()

    # (b) A long signal auto-routed to overlap-save: (32, 2^20) ⊛ 4097 taps,
    # block 65536, step 61440, 18 blocks; nothing planned past FUSED_MAX.
    L, LH = 1 << 20, 4097
    x, h = randn(32, L), randn(LH, scale=LH**-0.5)
    block = overlap.pick_block(LH)
    n_lib = next_pow2(L + LH - 1)
    logged = set(F.plan_log())
    yb = conv_case(
        "(b) fft_conv (32, 1048576) * 4097 -> overlap-save", lambda v: conv.fft_conv(v, h), x, h,
        plans_launches(rplans(block)), lambda v, hh: lib_conv(v, hh, n_lib, L),
        lambda y: rows_err(y, x, h, [0, 31], L), x[:0], (0, L),
        block=block, step=block - LH + 1, blocks=-(-L // (block - LH + 1)),
    )
    past = [s for s, name in F.plan_log()
            if (s, name) not in logged and max(s.n, s.n2 or 0) > plan_lib.FUSED_MAX]
    check(not past, f"(b): overlap-save planned past FUSED_MAX: {past}")

    # (c) The same signal as SAR strip ingest: 16 chunks of 65536 through
    # StreamingConv, the filter's spectrum made once at construction.
    sc, _ = held_call("(c) StreamingConv construction", lambda: overlap.StreamingConv(h),
                      plans_launches([(F.FFTSpec(block, kind="rfft"), 1)]))
    chunk = 65536

    def ingest(v):
        state, outs = sc.init_state(v.shape[:-1]), []
        for i in range(v.shape[-1] // chunk):
            y, state = sc(v[..., i * chunk:(i + 1) * chunk], state)
            outs.append(y)
        return torch.cat(outs, dim=-1)

    yc = conv_case(
        "(c) StreamingConv (32, 1048576) * 4097, 16 chunks of 65536", ingest, x, h,
        plans_launches(rplans(block, calls=(L // chunk, L // chunk))),
        lambda v, hh: lib_conv(v, hh, n_lib, L), lambda y: rows_err(y, x, h, [0, 31], L),
        x[:0], (0, L), chunks=L // chunk,
    )
    d = (yc - yb).abs().max().item() / yb.abs().max().item()
    check(d <= FFT_TOL, f"(c): the chunks' concatenation is off (b) by {d:.3e}·max|(b)|")
    del x, yb, yc, sc
    torch.cuda.empty_cache()

    # (d) SAR range compression of a 4096 x 8192 scene by a 1025-tap chirp,
    # per row: fft_conv2d "same", rfft2 at (4096, 16384).
    H, W = 4096, 8192
    img, chirp = randn(H, W), randn(1, 1025, scale=1025**-0.5)
    s2 = (next_pow2(H), next_pow2(W + 1024))
    conv_case(
        "(d) fft_conv2d (4096, 8192) * (1, 1025) same", lambda v: conv.fft_conv2d(v, chirp), img, chirp,
        plans_launches(rplans(s2[1], n2=s2[0])),
        lambda v, c: torch.fft.irfft2(torch.fft.rfft2(v, s=s2) * torch.fft.rfft2(c, s=s2), s=s2)[..., :H, :W],
        lambda y: rows_err(y, img, chirp[0], [0, H // 2, H - 1], W),
        img[None][:0], (0, H, W), n=s2[1], n2=s2[0],
    )
    del img
    torch.cuda.empty_cache()

    # (e) Complex batch packing: (1024, 16384) ⊛ 1025 taps, n = 32768.
    x, h = randn(1024, 16384), randn(1025, scale=1025**-0.5)
    n = next_pow2(16384 + 1024)
    conv_case(
        "(e) fft_conv_packed (1024, 16384) * 1025", lambda v: conv.fft_conv_packed(v, h), x, h,
        plans_launches([(F.FFTSpec(n), 1), (F.FFTSpec(n, kind="ifft"), 1), (F.FFTSpec(n, kind="rfft"), 1)]),
        lambda v, hh: lib_conv(v, hh, n, 16384), lambda y: rows_err(y, x, h, [0, 1, 1023], 16384),
        x[:0], (0, 16384), n=n,
    )

    # (f) The exact length at the sensor line 3000 ⊛ 1001: n = 4000, a
    # Bluestein child of 2000 and the recombination.
    x, h = randn(4096, 3000), randn(1001, scale=1001**-0.5)
    conv_case(
        "(f) fft_conv (4096, 3000) * 1001 pad=exact", lambda v: conv.fft_conv(v, h, pad="exact"), x, h,
        plans_launches(rplans(4000)), lambda v, hh: lib_conv(v, hh, 4000, 3000),
        lambda y: rows_err(y, x, h, [0, 4095], 3000), x[:0], (0, 3000), n=4000,
    )
    del x
    torch.cuda.empty_cache()
    mixer_case(gen)


def mixer_ref(m, x, ts) -> torch.Tensor:
    """The mixer's forward in float64 at positions ``ts`` of batch row 0 of
    ``x`` (B, S, D): the direct causal sum over the filter's taps."""
    x64 = x[0].double()
    u = x64 @ m.w_in.double()
    y = torch.stack([
        (u[t - k + 1:t + 1].flip(0) * m.filt[:, :k].double().T).sum(0)
        for t in ts for k in [min(t + 1, m.filter_len)]
    ])
    g = torch.nn.functional.silu(x64[ts] @ m.w_gate.double())
    return (y * g) @ m.w_out.double()


def mixer_full_ref(m, x) -> torch.Tensor:
    """The mixer's forward over every position and batch row of ``x``
    (B, L, D) in float64, its causal conv through ``torch.fft``."""
    x64 = x.double()
    n = next_pow2(x.shape[1] + m.filter_len - 1)
    u = x64 @ m.w_in.double()
    y = torch.fft.irfft(torch.fft.rfft(u, n=n, dim=1) * torch.fft.rfft(m.filt.double().T, n=n, dim=0),
                        n=n, dim=1)[:, :x.shape[1]]
    return (y * torch.nn.functional.silu(x64 @ m.w_gate.double())) @ m.w_out.double()


def mixer_case(gen) -> None:
    """(g): SpectralMixer at h2o-danube-1.8b's width, prefill of 4096 then
    512 stream-decode tokens (C = 256, flush block 2048): the prefill, every
    streamed token and 64 ring-decode tokens held against the float64
    forward over all positions and both batch rows; the streamed tokens also
    against the one-shot forward, the ring against the stream, five prefill
    positions against the direct sum, and the plan log."""
    B, S, T, D, LF = 2, 4096, 512, 2560, 1024
    m = SpectralMixer(D, LF, device="cuda", generator=torch.Generator().manual_seed(0))
    c, block = m.grain
    x = 0.5 * torch.randn(B, S + T, D, device="cuda", generator=gen)
    n = next_pow2(S + LF - 1)
    flush = plans_launches(rplans(block))
    prefill = plans_launches(rplans(n) + rplans(block))
    label = "(g) SpectralMixer (2, 4096, 2560) Lf=1024"
    with torch.no_grad():
        (out, cache), peak = held_call(f"{label} prefill", lambda: m(x[:, :S], return_cache=True), prefill)
        ref = mixer_full_ref(m, x)
        err = full_err(out, ref[:, :S])
        check(err <= FFT_TOL, f"{label}: prefill vs float64 {err:.3e}")
        ts = [0, 1, LF - 1, S // 2, S - 1]
        sums = mixer_ref(m, x, ts)
        err_sum = full_err(out[0, ts], sums)
        check(err_sum <= FFT_TOL, f"{label}: prefill vs the float64 direct sum {err_sum:.3e}")
        F.clear_plan_log()
        outs = []
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        before = kernels.counts()
        start.record()
        for t in range(S, S + T):
            y, cache = m.stream_decode(x[:, t:t + 1], cache)
            outs.append(y)
        end.record()
        end.synchronize()
        stream_ms = start.elapsed_time(end) / T
        check_launches(f"{label} stream decode", before, kernels.counts(),
                       {k: v * (T // c) for k, v in flush.items()})
        check(F.plan_log() == (), f"{label}: the warm decode planned {F.plan_log()}")
        streamed = torch.cat(outs, dim=1)
        err_stream = full_err(streamed, ref[:, S:])
        check(err_stream <= FFT_TOL, f"{label}: stream decode vs float64 {err_stream:.3e}")
        full = m(x)[:, S:]
        err_full = ((streamed - full).abs().max() / full.abs().max()).item()
        check(err_full <= FFT_TOL, f"{label}: stream decode vs one-shot forward {err_full:.3e}")

        ring = SpectralMixer(D, LF, decode_mode="ring", device="cuda")
        ring.load_state_dict(m.state_dict())
        _, rc = ring(x[:, :S], return_cache=True)
        ring_outs = []
        start.record()
        for t in range(S, S + 64):
            y, rc = ring.decode(x[:, t:t + 1], rc)
            ring_outs.append(y)
        end.record()
        end.synchronize()
        ring_ms = start.elapsed_time(end) / 64
        ringed = torch.cat(ring_outs, dim=1)
        err_ring64 = full_err(ringed, ref[:, S:S + 64])
        check(err_ring64 <= FFT_TOL, f"{label}: ring decode vs float64 {err_ring64:.3e}")
        err_ring = ((ringed - streamed[:, :64]).abs().max() / ringed.abs().max()).item()
        check(err_ring <= FFT_TOL, f"{label}: ring vs stream decode {err_ring:.3e}")
        del ref

        tail = cache.hist[..., c:]
        flush_ms = time_ms(lambda: m._lookahead(tail))
        flush_split = device_split(lambda: m._lookahead(tail))
        prefill_ms = time_ms(lambda: m(x[:, :S], return_cache=True))
        split = device_split(lambda: m(x[:, :S], return_cache=True))
        u = (x[:, :S] @ m.w_in).contiguous()
        conv_ms = time_ms(lambda: conv.fft_conv(u, m.filt, axis=1))
        lib_ms = time_ms(lambda: torch.fft.irfft(
            torch.fft.rfft(u, n=n, dim=1) * torch.fft.rfft(m.filt.T, n=n, dim=0), n=n, dim=1)[:, :S])
        print("conv " + json.dumps({
            "call": label, "launches": sum(prefill.values()) + sum(flush.values()) * (T // c),
            "prefill_launches": prefill, "flush_launches": flush, "flushes": T // c,
            "chunk": c, "block": block, "rel_err": err, "direct_sum_rel_err": err_sum,
            "stream_rel_err": err_stream, "ring_rel_err": err_ring64,
            "stream_vs_forward": err_full, "ring_vs_stream": err_ring, "prefill_ms": prefill_ms,
            "kernel_ms": split[0] if split else None, "other_device_ms": split[1] if split else None,
            "other_top": split[2] if split else None,
            "outside_kernels": (prefill_ms - split[0]) / prefill_ms if split else None,
            "flush_split": flush_split,
            "conv_ms": conv_ms, "library_ms": lib_ms, "stream_ms_per_token": stream_ms,
            "ring_ms_per_token": ring_ms, "flush_ms": flush_ms,
            "input_bytes": x[:, :S].numel() * 4, "call_peak_bytes": peak,
        }), flush=True)
        before = kernels.counts()
        z, empty_cache = m(x[:0, :S], return_cache=True)
        z2, _ = m.stream_decode(x[:0, :1], empty_cache)
        torch.cuda.synchronize()
        check_launches(f"{label} empty batch", before, kernels.counts(), {})
        check(tuple(z.shape) == (0, S, D) and tuple(z2.shape) == (0, 1, D), f"{label}: empty batch shapes")


#: The module holding each kernel's wrapper (``<name>_call``) and plain
#: version (``<name>_plain``).
KERNEL_MODULE = {
    "dft_matmul": dft_matmul, "fft4step": fft4step, "cols_pass": pencil, "rows_natural": pencil,
    "cols_natural": pencil, "rfft_recomb": pencil, "irfft_recomb": pencil,
    "bluestein_fwd": bluestein, "bluestein_inv": bluestein, "bluestein_elem": bluestein,
}


def _table_ids(t):
    """A wrapper argument after the planes, by identity: a LUT's storage."""
    if t is None or not isinstance(t, (torch.Tensor, tuple, list)):
        return t
    if isinstance(t, torch.Tensor):
        return t.data_ptr()
    return tuple(_table_ids(u) for u in t)


@contextlib.contextmanager
def recorded_calls():
    """Record every distinct non-empty kernel-wrapper call made inside the
    block: (kernel, the planes' shape, the arguments after the planes, the
    keywords), the LUTs kept by identity.  Yields the records' dict."""
    seen = {}

    def recording(name, call):
        def wrapper(xr, xi, *tables, **kw):
            if xr.numel() and xr.is_cuda:
                key = (name, tuple(xr.shape), _table_ids(tables), tuple(sorted(kw.items())))
                seen.setdefault(key, (name, tuple(xr.shape), tables, kw))
            return call(xr, xi, *tables, **kw)
        return wrapper

    saved = {name: getattr(mod, f"{name}_call") for name, mod in KERNEL_MODULE.items()}
    for name, call in saved.items():
        setattr(KERNEL_MODULE[name], f"{name}_call", recording(name, call))
    try:
        yield seen
    finally:
        for name, call in saved.items():
            setattr(KERNEL_MODULE[name], f"{name}_call", call)


def _tensors(t) -> list:
    if isinstance(t, torch.Tensor):
        return [t]
    if isinstance(t, (tuple, list)):
        return [u for v in t for u in _tensors(v)]
    return []


def call_flops(name: str, shape: tuple, tables: tuple, kw: dict, out_shape: tuple) -> float:
    """fp32 flops of one wrapper call, counted as phase 2 counts them."""
    if name in ("dft_matmul", "fft4step"):
        return shape[0] * fft_flops(shape[1])
    if name == "cols_pass":
        r, f, s_ = shape
        twiddle = tables[2] if len(tables) > 2 else kw.get("twiddle")
        return r * s_ * fft_flops(f) + (6 * r * f * s_ if twiddle is not None else 0)
    if name == "cols_natural":
        b, p_, f, w = shape
        return b * p_ * w * fft_flops(f)
    if name == "rows_natural":
        return shape[0] * shape[1] * fft_flops(shape[2])
    if name in ("rfft_recomb", "irfft_recomb"):
        return recomb_flops(math.prod(out_shape))
    if name == "bluestein_elem":
        return 6 * shape[0] * min(shape[1], out_shape[1])
    return shape[0] * bluestein_flops(name.split("_")[1], kw["n"], kw["m_pad"])


def path_kernel_rows(path: str, seen: dict, launches: dict, gen, timed: bool = True) -> None:
    """Each distinct kernel call a path made (:func:`recorded_calls`; every
    kernel that launched on it must have one), again on fresh planes of its
    shape with its own LUTs and keywords, against its plain version as phase
    2 holds it (bound: every input and LUT read once, every output written
    once); ``timed=False`` holds them without timing them ("kernel_check"
    lines).  These launches are not the path's."""
    recorded = {name for name, *_ in seen.values()}
    missed = [k for k in KERNEL_MODULE if launches.get(k) and k not in recorded]
    check(not missed, f"{path}: launches of {missed} were not recorded")
    for i, (name, shape, tables, kw) in enumerate(seen.values()):
        mod = KERNEL_MODULE[name]
        call, plain = getattr(mod, f"{name}_call"), getattr(mod, f"{name}_plain")
        plain_kw = {k: v for k, v in kw.items() if k in inspect.signature(plain).parameters}
        x = planes(gen, *shape)
        keys = " ".join(f"{k}={v}" for k, v in sorted(kw.items()))
        label = f"{path} path #{i} {'x'.join(map(str, shape))} {keys}".rstrip()
        run, run_plain = (lambda: call(*x, *tables, **kw)), (lambda: plain(*x, *tables, **plain_kw))
        if timed:
            out = run()
            nbytes = 4 * sum(t.numel() for t in _tensors((x, tables, out)))
            flops = call_flops(name, shape, tables, kw, tuple(out[0].shape))
            del out
            measure_kernel(name, label, run, run_plain, nbytes=nbytes, flops=flops)
        else:
            err, scale = check_kernel(label, run, run_plain)
            print("kernel_check " + json.dumps({"name": name, "shape": label, "max_abs_err": err,
                                                "rel_err": err / scale}), flush=True)
        del x
    torch.cuda.empty_cache()


def path_launches(name: str, phase, gen) -> dict:
    """Drive one path with the counts at 0; every kernel of the path must
    launch in it and no plain version may run.  A phase that runs work in
    other processes returns their counts, which are added."""
    kernels.reset_counts()
    others = phase(gen) or {}
    launches = kernels.counts()
    for key, count in others.items():
        launches[key] = launches.get(key, 0) + count
    for kernel in PATH_KERNELS[name]:
        check(launches[kernel] > 0, f"{kernel} was not launched on the {name} path")
    for key, count in launches.items():
        check(not key.endswith("_plain") or count == 0, f"{key} ran on the {name} path")
    print(f"{name}_launches " + json.dumps(launches), flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 8: the decoder LM served at h2o-danube-1.8b's width
# ---------------------------------------------------------------------------

SERVE_SLOTS, SERVE_MAX_LEN = 4, 4608
#: Prompts admitted into an empty batch, then one inserted into the running
#: batch after SERVE_FIRST_STEPS steps; SERVE_STEPS more follow.
SERVE_PROMPTS, SERVE_LATE = (4096, 1000, 37), 2048
SERVE_FIRST_STEPS, SERVE_STEPS = 96, 416
SERVE_TOL = 1e-3  # served float32 logits vs the teacher-forced logits_fn, relative to max|ref|
BF16_TOL = 5e-2  # bf16 prefill logits vs the float32 run's, relative to max|ref| (PERF.md §6)


def serve_config():
    """h2o-danube-1.8b with the paper-integration flag: ("spectral", "attn")
    × 12 at d_model 2560, 32/8 heads, d_ff 6912, vocab 32000, Lf 1024."""
    return dataclasses.replace(get_config("h2o-danube-1.8b"), use_spectral_mixer=True)


def recording(model) -> dict:
    """Keep every logit row ``model.prefill`` and ``model.decode_step``
    return (instance attributes shadowing the methods; ``del`` restores)."""
    rows = {"prefill": [], "decode": []}
    prefill, decode_step = model.prefill, model.decode_step

    def rec_prefill(*args, **kwargs):
        logits, caches = prefill(*args, **kwargs)
        rows["prefill"].append(logits)
        return logits, caches

    def rec_decode(*args, **kwargs):
        logits, caches = decode_step(*args, **kwargs)
        rows["decode"].append(logits)
        return logits, caches

    model.prefill, model.decode_step = rec_prefill, rec_decode
    return rows


def serve_session(model, prompts, late, first_steps: int = SERVE_FIRST_STEPS) -> ServeSession:
    """4 slots, max_len 4608, EOS outside the vocabulary (every slot decodes
    every step): the three prompts admitted, ``first_steps`` steps, the late
    prompt inserted into the running batch (re-phased)."""
    sess = ServeSession(Engine(model, ServeConfig(eos_id=model.cfg.vocab_size)), slots=SERVE_SLOTS,
                        max_len=SERVE_MAX_LEN)
    for p in prompts:
        sess.submit(p)
    sess.run(first_steps)
    sess.submit(late)
    return sess


def timed_run(sess, steps: int) -> float:
    """ms of ``sess.run(steps)`` on the host clock (it ends in the run's sync)."""
    before = sess.phase_s["generate"]
    sess.run(steps)
    return (sess.phase_s["generate"] - before) * 1e3


def serve_expect(model, seq_lens, flushes: int = 2, bare_prefills: int = 0) -> dict:
    """Kernel → launches phase 8 must make: each spectral layer runs
    ``fft_conv`` (rfft twice, irfft once at next_pow2(S + Lf − 1)) and the
    stream state's lookahead (rfft twice, irfft once at the flush block) per
    prefill, the lookahead per insert and per flush (``flushes`` a session),
    and the conv per teacher-forced ``logits_fn`` of ``seq_lens``; two
    sessions; the timed prefills four times each, the longest once more
    under the profiler, and ``bare_prefills`` more of each prompt (phase 11's
    float32 reference prefills)."""
    mixer = model.stack[0].mixer
    lf, (_, block) = mixer.filter_len, mixer.grain
    conv = lambda s: rplans(next_pow2(s + lf - 1))  # noqa: E731
    lens = SERVE_PROMPTS + (SERVE_LATE,)
    prefills = [u for s in lens for u in conv(s) + rplans(block)]
    session = prefills + rplans(block, calls=(2 * (len(lens) + flushes), len(lens) + flushes))  # 4 inserts
    timed = [u for s in lens for u in rplans(next_pow2(s + lf - 1), calls=(8, 4)) + rplans(block, calls=(8, 4))]
    profiled = conv(lens[0]) + rplans(block)
    uses = 2 * session + timed + profiled + bare_prefills * prefills + [u for s in seq_lens for u in conv(s)]
    layers = sum(block.kind == "spectral" for block in model.stack)
    return {k: v * layers for k, v in plans_launches(uses).items()}


def split_keys(prefix: str, split, ms: float) -> dict:
    """A :func:`device_split` as the serve line's keys: the port's kernels'
    and the other device ms, the other's largest names, and the busy share
    of a call of ``ms`` (None where the trace held no device time)."""
    kernel, other, top = split or (None, None, None)
    return {f"{prefix}_kernel_ms": kernel, f"{prefix}_other_device_ms": other, f"{prefix}_other_top": top,
            f"{prefix}_busy": (kernel + other) / ms if split else None}


def serve_phase(gen) -> None:
    """Phase 8: build the full-width model on the card, serve four requests
    (one inserted into the running batch) at bf16 compute, then the same
    requests at float32 compute on the same weights, every served float32
    logit row against one teacher-forced ``logits_fn`` and the bf16 prefill
    logits against the float32 ones; launches exact, timed, profiled."""
    cfg, dev = serve_config(), gen.device
    torch.cuda.reset_peak_memory_stats()
    model = DecoderLM(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    check(model.stack[0].kind == "spectral" and len(model.stack) == cfg.num_layers,
          f"phase 8: {len(model.stack)} layers of {cfg.num_layers}")
    prompts = [torch.randint(4, cfg.vocab_size, (n,), device=dev, generator=gen) for n in SERVE_PROMPTS]
    late = torch.randint(4, cfg.vocab_size, (SERVE_LATE,), device=dev, generator=gen)
    c, block = model.stack[0].mixer.grain
    at_start = kernels.counts()

    # bf16 compute (the config's): the timed and profiled serve.
    rows16 = recording(model)
    sess = serve_session(model, prompts, late)
    first_ms = sess.phase_s["generate"] * 1e3
    flush_at = (c - 1 - SERVE_FIRST_STEPS) % c  # steps before the first flush of the second run
    ms_a = timed_run(sess, flush_at)
    check(sess.state.caches[0].phase == c - 1, f"phase 8: phase {sess.state.caches[0].phase} before the flush")
    # The session's first flush is profiled (it also grows the allocator's
    # pool), the second timed.
    flush_split = device_split(lambda: sess.run(1))
    step_split = device_split(lambda: sess.run(1))
    rest = SERVE_STEPS - flush_at - 3
    ms_b = timed_run(sess, rest)
    check(sess.state.caches[0].phase == c - 1, "phase 8: the last step is not a flush")
    flush_ms = timed_run(sess, 1)
    out16 = [sess.output(s) for s in range(SERVE_SLOTS)]
    insert_ms = sess.phase_s["insert"] * 1e3 / SERVE_SLOTS
    del sess, model.prefill, model.decode_step
    torch.cuda.empty_cache()

    # float32 compute on the same weights and kernels.
    m32 = DecoderLM(dataclasses.replace(cfg, compute_dtype="float32"), device="meta")
    m32.load_state_dict(model.state_dict(), assign=True)
    rows32 = recording(m32)
    F.clear_plan_log()
    sess = serve_session(m32, prompts, late)
    sess.run(SERVE_STEPS)
    check(F.plan_log() == (), f"phase 8: the warm session planned {F.plan_log()}")
    out32 = [sess.output(s) for s in range(SERVE_SLOTS)]
    del sess, m32.prefill, m32.decode_step

    requests = [(p, slot, 0) for slot, p in enumerate(prompts)] + [(late, len(prompts), SERVE_FIRST_STEPS)]
    errs, errs16, seq_lens = [], [], []
    for j, (p, slot, start) in enumerate(requests):
        out, out_16 = out32[slot], out16[slot]
        want = 1 + SERVE_FIRST_STEPS + SERVE_STEPS - start
        check(len(out) == len(out_16) == want, f"phase 8 request {j}: {len(out)}/{len(out_16)} tokens, expected {want}")
        check(max(out + out_16) < cfg.vocab_size and min(out + out_16) >= 0, f"phase 8 request {j}: token out of vocab")
        served = torch.cat([rows32["prefill"][j]] + [rows32["decode"][k][slot:slot + 1]
                                                     for k in range(start, start + want - 1)])
        check(bool(torch.isfinite(served).all()), f"phase 8 request {j}: non-finite served logits")
        check(served.argmax(-1).tolist() == out, f"phase 8 request {j}: emitted tokens are not the greedy ones")
        seq = torch.cat([p, torch.tensor(out[:-1], device=dev)])[None]
        seq_lens.append(seq.shape[1])
        hidden = m32(seq)[0][0, len(p) - 1:]
        errs.append(full_err(served, m32.head(hidden, m32.embed.table)))
        check(errs[-1] <= SERVE_TOL, f"phase 8 request {j}: served vs teacher-forced {errs[-1]:.3e} > {SERVE_TOL}")
        errs16.append(full_err(rows16["prefill"][j], rows32["prefill"][j].double()))
        check(errs16[-1] <= BF16_TOL, f"phase 8 request {j}: bf16 prefill vs float32 {errs16[-1]:.3e} > {BF16_TOL}")
        del served, hidden
    agree = [sum(a == b for a, b in zip(out16[s], out32[s])) / len(out32[s]) for s in range(SERVE_SLOTS)]
    del rows32, m32
    torch.cuda.empty_cache()

    # Each prompt length's prefill at bf16, warm (CUDA events, median of 3).
    eng = Engine(model, ServeConfig(eos_id=cfg.vocab_size))
    g = eng.generator(0)
    prefill_ms = {
        n: time_ms(lambda p=p: eng.prefill(p[None], max_len=SERVE_MAX_LEN, generator=g), reps=3)
        for n, p in zip(SERVE_PROMPTS + (SERVE_LATE,), prompts + [late])
    }
    prefill_split = device_split(lambda: eng.prefill(prompts[0][None], max_len=SERVE_MAX_LEN, generator=g))
    check_launches("phase 8", at_start, kernels.counts(), serve_expect(model, seq_lens))
    step_ms = (ms_a + ms_b) / (flush_at + rest)
    print("serve " + json.dumps({
        "config": cfg.name + " use_spectral_mixer", "layers": len(model.stack), "parameters": n_params,
        "slots": SERVE_SLOTS, "max_len": SERVE_MAX_LEN, "prompts": list(SERVE_PROMPTS), "late": SERVE_LATE,
        "chunk": c, "block": block, "served_vs_teacher_forced": errs, "bf16_vs_float32_prefill": errs16,
        "bf16_float32_token_agreement": agree, "prefill_ms": prefill_ms, "insert_ms": insert_ms,
        "decode_ms_per_step": step_ms, "decode_tok_per_s": SERVE_SLOTS * 1e3 / step_ms,
        "first_run_ms_per_step_3_slots": first_ms / SERVE_FIRST_STEPS, "flush_step_ms": flush_ms,
        **split_keys("prefill", prefill_split, prefill_ms[SERVE_PROMPTS[0]]),
        **split_keys("step", step_split, step_ms), **split_keys("flush", flush_split, flush_ms),
        "peak_bytes": torch.cuda.max_memory_allocated(), "param_bytes": 4 * n_params,
    }), flush=True)
    del model, eng
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 9: the tuner on the card
# ---------------------------------------------------------------------------

TUNE_MODES = ("off", "model", "measure")

#: Phase 9's plan specs, each at the batch it runs at (``batch_hint``, which
#: the tuner measures at): the Table 1 lengths of phase 3 at its batches,
#: 2^17 (0.27 GB) and 2^20, the SAR scene of phase 7 (d) (4096 lines of 8192
#: samples), and phase 6's any-length lines, whose pads the tuner doubles.
TUNE_SPECS = (
    F.FFTSpec(1024, batch_hint=16384),
    F.FFTSpec(4096, batch_hint=4096),
    F.FFTSpec(16384, batch_hint=4096),
    F.FFTSpec(65536, batch_hint=1024),
    F.FFTSpec(1 << 17, batch_hint=256),
    F.FFTSpec(1 << 20, batch_hint=64),
    F.FFTSpec(8192, kind="fft2", n2=4096, batch_hint=1),
    F.FFTSpec(3000, batch_hint=8192),
    F.FFTSpec(100003, batch_hint=64),
)


@contextlib.contextmanager
def tune_env(mode: str):
    """``REPRO_FFT_TUNE=mode`` inside the block: the mode of every plan made
    without naming one (a convolution's own plans)."""
    was = os.environ.get("REPRO_FFT_TUNE")
    os.environ["REPRO_FFT_TUNE"] = mode
    try:
        yield
    finally:
        if was is None:
            os.environ.pop("REPRO_FFT_TUNE")
        else:
            os.environ["REPRO_FFT_TUNE"] = was


def measured(fn) -> tuple:
    """``fn()`` and the number of tuner measurements it made."""
    before = len(tuning.measure_log())
    out = fn()
    return out, len(tuning.measure_log()) - before


def replan(label: str, spec, mode: str, cfg) -> None:
    """Plan ``spec`` again with the interned plans dropped, through the
    process's tuning cache and then through a fresh ``TuningCache`` over the
    same file: both find ``cfg`` and measure nothing."""
    F._plan_cached.cache_clear()
    again, made = measured(lambda: F.plan(spec, tune=mode))
    check(made == 0 and again.tuned == cfg, f"{label} {mode}: a second plan() measured {made} times")
    tuning.cache = tuning.TuningCache()
    F._plan_cached.cache_clear()
    fresh, made = measured(lambda: F.plan(spec, tune=mode))
    check(made == 0 and fresh.tuned == cfg,
          f"{label} {mode}: a fresh TuningCache measured {made} times, config {fresh.tuned}")


def complex_err(y, ref) -> float:
    """max|Δ| / max|ref| of a complex64 output against a complex128 one."""
    return ((y.to(torch.complex128) - ref).abs().max() / ref.abs().max()).item()


def tuned_plans(gen, spec) -> dict:
    """One spec planned in each mode, each plan held and timed; returns the
    phase-9 line's fields."""
    b, n2 = spec.batch_hint, spec.n2
    shape = (b, n2, spec.n) if n2 else (b, spec.n)
    label = f"{spec.kind} {'x'.join(map(str, shape))}"
    x = torch.complex(*planes(gen, *shape))
    lib = torch.fft.fft2 if n2 else torch.fft.fft
    ref = lib(x.to(torch.complex128))
    row = {"spec": label, "configs": {}, "kernels": {}, "ms": {}, "measurements": {}, "plan_s": {},
           "rel_err": {}}
    for mode in TUNE_MODES:
        t0 = time.perf_counter()
        planned, made = measured(lambda: F.plan(spec, tune=mode))
        row["plan_s"][mode] = time.perf_counter() - t0
        check(made == 0 or mode == "measure", f"{label} {mode}: planning measured {made} times")
        check((planned.tuned is None) == (mode == "off"), f"{label} {mode}: tuned {planned.tuned}")
        y, _ = counted_call(f"{label} {mode}", planned, x)
        err = complex_err(y, ref)
        check(err <= FFT_TOL, f"{label} {mode}: vs torch.fft in float64 {err:.3e} > {FFT_TOL}·max|ref|")
        del y
        before = kernels.counts()
        z = planned(x[:0])
        torch.cuda.synchronize()
        check_launches(f"{label} {mode} empty batch", before, kernels.counts(), {})
        check(tuple(z.shape) == (0,) + shape[1:], f"{label} {mode} empty batch: {tuple(z.shape)}")
        row["ms"][mode] = time_ms(lambda: planned(x), reps=3, warmup=1)
        row["configs"][mode] = planned.tuned
        row["kernels"][mode] = list(planned.kernels)
        row["measurements"][mode] = made
        row["rel_err"][mode] = err
        if mode != "off":
            replan(label, spec, mode, planned.tuned)
    row["library_ms"] = time_ms(lambda: lib(x), reps=3, warmup=1)  # the yardstick only
    del x, ref
    torch.cuda.empty_cache()
    return row


def tuned_convs(gen) -> None:
    """Phase 7 (b)'s overlap-save conv and (c)'s ingest with a StreamingConv
    keyed to its 65536-sample chunks, each mode throughout (the block and
    the conv's own plans): the tuned block, the output against the float64
    conv through ``torch.fft``, exact launches, ms."""
    L, LH, B, chunk = 1 << 20, 4097, 32, 65536
    x = torch.randn(B, L, device="cuda", generator=gen)
    h = LH**-0.5 * torch.randn(LH, device="cuda", generator=gen)
    n_lib = next_pow2(L + LH - 1)
    ref = lib_conv(x.double(), h.double(), n_lib, L)
    for mode in TUNE_MODES:
        with tune_env(mode):
            block, made = measured(lambda: tuning.tuned_block(L, LH, B, x.device, mode))
            label = f"(b) fft_conv_os (32, 1048576) * 4097 tune={mode}"
            y, peak = held_call(label, lambda: overlap.fft_conv_os(x, h, tune=mode),
                                plans_launches(rplans(block)))
            err = full_err(y, ref)
            check(err <= FFT_TOL, f"{label}: vs the float64 reference {err:.3e} > {FFT_TOL}·max|ref|")
            del y
            ms = time_ms(lambda: overlap.fft_conv_os(x, h, tune=mode), reps=3, warmup=1)
            _, again = measured(lambda: tuning.tuned_block(L, LH, B, x.device, mode))
            check(again == 0, f"{label}: a second decision measured {again} times")
            held_call(f"{label} empty batch", lambda: overlap.fft_conv_os(x[:0], h, tune=mode), {})
            print("tune_conv " + json.dumps({"call": label, "block": block, "measurements": made,
                                             "rel_err": err, "ms": ms, "call_peak_bytes": peak}),
                  flush=True)

            sc, made = measured(lambda: overlap.StreamingConv(h, tune=mode, chunk_hint=chunk))

            def ingest(v):
                state, outs = sc.init_state(v.shape[:-1]), []
                for i in range(v.shape[-1] // chunk):
                    yc, state = sc(v[..., i * chunk:(i + 1) * chunk], state)
                    outs.append(yc)
                return torch.cat(outs, dim=-1)

            label = f"(c) StreamingConv chunk_hint=65536, 16 chunks tune={mode}"
            calls = L // chunk
            y, _ = held_call(label, lambda: ingest(x), plans_launches(rplans(sc.block, calls=(calls, calls))))
            err = full_err(y, ref)
            check(err <= FFT_TOL, f"{label}: vs the float64 reference {err:.3e} > {FFT_TOL}·max|ref|")
            del y
            ms = time_ms(lambda: ingest(x), reps=3, warmup=1)
            print("tune_conv " + json.dumps({"call": label, "block": sc.block, "measurements": made,
                                             "rel_err": err, "ms": ms}), flush=True)
    del x, ref
    torch.cuda.empty_cache()


def tune_phase(gen) -> None:
    """Phase 9: every spec in each mode, the tuned convolutions, the stream
    plan of h2o-danube-1.8b; the shipped seed is set aside so that the
    first "measure" plan of each spec measures on this card."""
    seed, tuning._SEED_CACHE = tuning.seed_cache(), {}
    try:
        for spec in TUNE_SPECS:
            print("tune " + json.dumps(tuned_plans(gen, spec)), flush=True)
        tuned_convs(gen)
    finally:
        tuning._SEED_CACHE = seed
    info = stream_plan_info(serve_config(), batch=SERVE_SLOTS)
    print("tune_stream_plan " + json.dumps(info), flush=True)
    # The winners this run measured, beside the shipped seed's.
    entries = tuning.TuningCache()._read_file(tuning.cache_path())
    won = {k: v for k, v in entries.items() if v.get("mode") == "measure"}
    agree = sum(seed.get(k, {}).get("config") == v["config"] for k, v in won.items())
    print("tune_cache " + json.dumps({"measured": won, "seed_entries": len(seed),
                                      "seed_agrees": agree}), flush=True)


# ---------------------------------------------------------------------------
# phase 10: gradients through the kernels, and training
# ---------------------------------------------------------------------------

GRAD_TOL = 1e-3  # a vjp through the kernels vs float64, relative to max|ref|
DOT_TOL = 1e-5  # |⟨F x, g⟩ − ⟨x, Fᴴ g⟩| relative to ‖F x‖·‖g‖

#: (spec, input shape): the backward of every kind at the batches of phases
#: 3, 5 and 6, the 2-D columns cut to 512-point rows.  fft 1024 (#1), 16384
#: (#2), 2^20 (#3, #4); fft2 with strip-mined columns (#5); rfft / irfft
#: 8192 (#6); fft 3000 (#7, #8); fft 100003, the split regime (#9).
GRAD_CASES = (
    (F.FFTSpec(1024), (16384, 1024)),
    (F.FFTSpec(16384), (4096, 16384)),
    (F.FFTSpec(1 << 20), (64, 1 << 20)),
    (F.FFTSpec(512, kind="fft2", n2=1 << 17), (1, 1 << 17, 512)),
    (F.FFTSpec(8192, kind="rfft"), (8192, 8192)),
    (F.FFTSpec(8192, kind="irfft"), (8192, 4097)),
    (F.FFTSpec(3000), (8192, 3000)),
    (F.FFTSpec(100003), (64, 100003)),
)
#: Rows of the irfft case held against the port's CPU route.
IRFFT_ROWS = 64

OPPOSITE = {"fft": "ifft", "ifft": "fft", "rfft": "irfft", "irfft": "rfft", "fft2": "ifft2",
            "ifft2": "fft2", "rfft2": "irfft2", "irfft2": "rfft2"}


def opposite(spec):
    return F.plan(dataclasses.replace(spec, kind=OPPOSITE[spec.kind]))


def _inner(a, b) -> float:
    """Σ a·b over planes, in float64."""
    return sum(float((u.double() * v.double()).sum()) for u, v in zip(a, b))


def _norm(a) -> float:
    return math.sqrt(sum(float(u.double().square().sum()) for u in a))


@contextlib.contextmanager
def uncounted():
    """Every counter set back after the block to what it was before it."""
    saved = [dict(mod.COUNTS) for mod in kernels.KERNEL_MODULES]
    try:
        yield
    finally:
        for mod, counts in zip(kernels.KERNEL_MODULES, saved):
            mod.COUNTS.update(counts)


def grad_case(gen, spec, shape) -> dict:
    """One kind's backward on the card: the vjp through the kernels against
    ``torch.fft``'s autograd in float64 (irfft: the port's CPU route on
    sample rows, since ``torch.fft.irfft`` drops the imaginary parts of
    bins 0 and n/2 that this package's irfft reads), the dot test, exactly
    the opposite direction's launches and no plain call, timed beside
    ``torch.fft``'s backward in float32."""
    reps, warmup = 3, 1
    planned = F.plan(spec)
    real_in, real_out = spec.kind == "rfft", spec.kind == "irfft"
    label = f"{spec.kind} {'x'.join(map(str, shape))} backward"
    xs = [torch.randn(*shape, device="cuda", generator=gen) for _ in range(1 if real_in else 2)]
    for t in xs:
        t.requires_grad_(True)
    y = planned(xs[0]) if real_in else planned(tuple(xs))
    ys = [y] if real_out else list(y)
    check(all(t.requires_grad for t in ys), f"{label}: the output is not attached to the graph")
    gs = [torch.randn(*t.shape, device="cuda", generator=gen) for t in ys]
    expect = launches_per_call(opposite(spec))
    before = kernels.counts()
    vjp = torch.autograd.grad(ys, xs, gs, retain_graph=True)
    torch.cuda.synchronize()
    check_launches(label, before, kernels.counts(), expect)
    check(all(bool(torch.isfinite(v).all()) for v in vjp), f"{label}: non-finite gradient")

    ys_, xs_ = [t.detach() for t in ys], [t.detach() for t in xs]
    dot = abs(_inner(ys_, gs) - _inner(xs_, vjp)) / (_norm(ys_) * _norm(gs))
    check(dot <= DOT_TOL, f"{label}: dot test {dot:.3e} > {DOT_TOL}")
    if real_out:
        rows = slice(0, IRFFT_ROWS)
        cpu = F.plan(spec, device="cpu")
        xc = [t.detach()[rows].cpu().requires_grad_(True) for t in xs]
        with uncounted():  # the reference's plain calls are not the path's
            ref = torch.autograd.grad(cpu(tuple(xc)), xc, gs[0][rows].cpu())
        err = max(full_err(v[rows].cpu(), r.double()) for v, r in zip(vjp, ref))
    else:
        lib = library_call(spec)
        x64 = (xs[0].detach().double() if real_in
               else torch.complex(xs[0].detach().double(), xs[1].detach().double())).requires_grad_(True)
        y64 = lib(x64)
        g64 = torch.complex(gs[0].double(), gs[1].double())
        (r64,) = torch.autograd.grad(y64, x64, g64)
        ref = [r64] if real_in else [r64.real, r64.imag]
        err = max(full_err(v, r) for v, r in zip(vjp, ref))
        del x64, y64, g64, r64
    check(err <= GRAD_TOL, f"{label}: vjp vs the float64 reference {err:.3e} > {GRAD_TOL}·max|ref|")
    del ref
    ms = time_ms(lambda: torch.autograd.grad(ys, xs, gs, retain_graph=True), reps=reps, warmup=warmup)
    fwd_ms = time_ms(lambda: planned(xs[0].detach()) if real_in else planned(tuple(t.detach() for t in xs)),
                     reps=reps, warmup=warmup)
    # The library's backward in float32 on the same shapes (the yardstick).
    lib = library_call(spec)
    xl = (xs[0].detach().clone() if real_in else torch.complex(xs[0].detach(), xs[1].detach())).requires_grad_(True)
    yl, gl = lib(xl), (gs[0] if real_out else torch.complex(*gs))
    lib_ms = time_ms(lambda: torch.autograd.grad(yl, xl, gl, retain_graph=True), reps=reps, warmup=warmup)
    row = {"call": label, "kernels": expect, "rel_err": err, "dot_rel_err": dot, "backward_ms": ms,
           "forward_ms": fwd_ms, "library_backward_ms": lib_ms,
           "reference": "port CPU route, sample rows" if real_out else "torch.fft autograd, float64"}
    print("grad " + json.dumps(row), flush=True)
    return row


@contextlib.contextmanager
def swapped_conv(dtype):
    """The spectral mixer's convolution replaced by the same causal conv
    through ``torch.fft`` in ``dtype`` (float64: the reference the
    gradients are held against; float32: the library yardstick)."""
    from repro_torch.models.layers import spectral as spectral_mod

    def conv_lib(x, h, axis=1):
        L = x.shape[axis]
        n = next_pow2(L + h.shape[-1] - 1)
        X = torch.fft.rfft(x.to(dtype), n=n, dim=axis)
        H = torch.fft.rfft(h.to(dtype).T, n=n, dim=0)
        return torch.fft.irfft(X * H, n=n, dim=axis).narrow(axis, 0, L).to(torch.float32)

    was = spectral_mod.fft_conv
    spectral_mod.fft_conv = conv_lib
    try:
        yield
    finally:
        spectral_mod.fft_conv = was


def tensor_errs(got: dict, ref: dict) -> dict:
    """max|Δ|/max|ref| of each named tensor."""
    return {k: full_err(got[k], ref[k].double()) for k in ref}


def mixer_grad_case(gen) -> None:
    """(b): SpectralMixer at h2o-danube-1.8b's width, forward and backward:
    the gradients of x, filt and the three projections against the same
    module with its convolution through ``torch.fft`` in float64, exact
    launches, fwd+bwd ms beside the swapped module in float32, the FFT
    kernels' share of the device time."""
    B, S, D, LF = 2, 4096, 2560, 1024
    m = SpectralMixer(D, LF, device="cuda", generator=torch.Generator().manual_seed(0))
    x = (0.5 * torch.randn(B, S, D, device="cuda", generator=gen)).requires_grad_(True)
    cot = torch.randn(B, S, D, device="cuda", generator=gen)
    names = ["x"] + [n for n, _ in m.named_parameters()]
    wrt = [x] + list(m.parameters())

    def fwd_bwd():
        return dict(zip(names, torch.autograd.grad(m(x), wrt, cot)))

    n = next_pow2(S + LF - 1)
    expect = plans_launches(rplans(n, calls=(3, 3)))  # forward 2 rfft + irfft; backward the opposite
    label = f"(b) SpectralMixer ({B}, {S}, {D}) Lf={LF} forward + backward"
    got, peak = held_call(label, fwd_bwd, expect)
    with swapped_conv(torch.float64):
        ref = fwd_bwd()
    errs = tensor_errs(got, ref)
    worst = max(errs.values())
    check(worst <= GRAD_TOL, f"{label}: gradients vs float64 {errs}")
    del got, ref
    ms = time_ms(fwd_bwd, reps=3)
    split = device_split(fwd_bwd)
    with swapped_conv(torch.float32):
        lib_ms = time_ms(fwd_bwd, reps=3)
    print("grad_mixer " + json.dumps({
        "call": label, "launches": expect, "rel_err": errs, "fwd_bwd_ms": ms,
        "library_fwd_bwd_ms": lib_ms, "kernel_ms": split[0] if split else None,
        "other_device_ms": split[1] if split else None, "other_top": split[2] if split else None,
        "fft_kernel_share": split[0] / (split[0] + split[1]) if split else None,
        "call_peak_bytes": peak,
    }), flush=True)
    del m, x, cot
    torch.cuda.empty_cache()


#: Phase 10 (c): h2o-danube-1.8b + use_spectral_mixer at full width, bf16
#: compute, remat, AdamW, TRAIN_STEPS steps on one repeated batch of
#: TRAIN_BATCH sequences of the reference's train_4k length.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 4096, 8
#: The save-and-resume check: the same width at TRAIN_CKPT_LAYERS layers.
TRAIN_CKPT_LAYERS, TRAIN_CKPT_STEPS = 2, 4


#: Phase 10 (c)'s losses and ms a step: phase 15 (a)'s baseline.
TRAIN_RECORD: dict = {}


def train_config():
    from repro_torch.configs.base import TrainConfig

    return TrainConfig(learning_rate=3e-4, warmup_steps=1, total_steps=TRAIN_STEPS,
                       batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ)


def step_expect(model, seq: int) -> dict:
    """Kernel → launches of one train step: each spectral layer's conv
    (rfft twice, irfft once) in the forward and again in the remat
    recompute, and the backward's opposite directions (irfft twice, rfft
    once)."""
    lf = model.stack[0].mixer.filter_len
    calls = (5, 4) if model.cfg.remat else (3, 3)
    layers = sum(block.kind == "spectral" for block in model.stack)
    return {k: v * layers for k, v in plans_launches(rplans(next_pow2(seq + lf - 1), calls=calls)).items()}


def loss_and_grads(model, batch) -> tuple:
    from repro_torch.models.model import loss_fn

    names, params = zip(*model.named_parameters())
    loss, _ = loss_fn(model, batch)
    return loss.detach(), dict(zip(names, torch.autograd.grad(loss, params)))


def float32_check(model, batch) -> dict:
    """One float32 step's loss and every parameter's gradient (the same
    weights at float32 compute) against the same step with the mixers'
    convolution through ``torch.fft`` in float64."""
    from repro_torch.models.model import DecoderLM

    m32 = DecoderLM(dataclasses.replace(model.cfg, compute_dtype="float32"), device="meta")
    m32.load_state_dict(model.state_dict(), assign=True)
    loss, grads = loss_and_grads(m32, batch)
    with swapped_conv(torch.float64):
        ref_loss, ref = loss_and_grads(m32, batch)
    errs = tensor_errs(grads, ref)
    loss_err = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
    worst = max(errs, key=errs.get)
    check(loss_err <= GRAD_TOL, f"phase 10 float32 loss vs the float64 conv swap {loss_err:.3e}")
    check(errs[worst] <= GRAD_TOL, f"phase 10 float32 gradient {worst} vs the float64 conv swap {errs[worst]:.3e}")
    del m32, grads, ref
    torch.cuda.empty_cache()
    return {"loss": float(loss), "loss_rel_err": loss_err, "grad_worst": worst, "grad_worst_rel_err": errs[worst],
            "grad_median_rel_err": statistics.median(errs.values()), "tensors": len(errs)}


def resume_check(cfg, tc, batches) -> dict:
    """TRAIN_CKPT_STEPS steps straight at TRAIN_CKPT_LAYERS layers of the
    same width, against half of them, an async checkpoint, a fresh state
    restored from it (every tensor equal to the saved one) and the other
    half: the same losses at 1e-3."""
    import shutil

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.train.train_loop import init_train_state, make_train_step

    small = dataclasses.replace(cfg, num_layers=TRAIN_CKPT_LAYERS)
    step = make_train_step(small, tc)

    def fresh(seed):
        return init_train_state(small, tc, device="cuda", generator=torch.Generator(device="cuda").manual_seed(seed))

    straight, losses = fresh(0), []
    for i in range(TRAIN_CKPT_STEPS):
        straight, met = step(straight, batches(i))
        losses.append(met["loss"])
    half = TRAIN_CKPT_STEPS // 2
    run = fresh(0)
    for i in range(half):
        run, _ = step(run, batches(i))
    directory = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke", "ckpt")
    shutil.rmtree(directory, ignore_errors=True)
    mgr = CheckpointManager(directory, keep=1)
    t0 = time.perf_counter()
    mgr.save(half, run, extra={"data_step": half}, blocking=False)
    mgr.wait()
    save_s = time.perf_counter() - t0
    disk = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(directory) for f in fs)
    t0 = time.perf_counter()
    resumed, extra = mgr.restore(mgr.latest_step(), fresh(1))
    restore_s = time.perf_counter() - t0
    same = all(torch.equal(a, b) for (_, a), (_, b) in zip(resumed.model.named_parameters(),
                                                            run.model.named_parameters()))
    same &= all(torch.equal(resumed.opt_state.inner[k][n], run.opt_state.inner[k][n])
                for k in ("m", "v") for n in run.opt_state.inner[k])
    check(same and resumed.step == half == extra["data_step"], "phase 10: the restored state is not the saved one")
    del run
    resumed_losses = []
    for i in range(half, TRAIN_CKPT_STEPS):
        resumed, met = step(resumed, batches(i))
        resumed_losses.append(met["loss"])
    errs = [abs(float(a) - float(b)) / abs(float(b)) for a, b in zip(resumed_losses, losses[half:])]
    check(max(errs) <= GRAD_TOL, f"phase 10: resumed losses {resumed_losses} vs straight {losses[half:]}")
    shutil.rmtree(directory, ignore_errors=True)
    del straight, resumed
    torch.cuda.empty_cache()
    return {"layers": TRAIN_CKPT_LAYERS, "steps": TRAIN_CKPT_STEPS, "resumed_at": half,
            "checkpoint_bytes": disk, "save_s": save_s, "restore_s": restore_s, "loss_rel_errs": errs}


def train_case(gen) -> None:
    """(c): train h2o-danube-1.8b + use_spectral_mixer at full width."""
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.train_loop import init_train_state, make_train_step

    cfg, tc = serve_config(), train_config()
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(cfg, tc, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))
    model = state.model
    n_params = sum(p.numel() for p in model.parameters())
    check(len(model.stack) == cfg.num_layers == 24 and model.cfg.remat, "phase 10: not the full model")
    dcfg = DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH)
    batch = {k: v.cuda() for k, v in make_batch(dcfg, 0).items()}

    f32 = float32_check(model, batch)
    step = make_train_step(cfg, tc)
    expect = step_expect(model, TRAIN_SEQ)
    losses, step_counts = [], []
    F.clear_plan_log()
    torch.cuda.synchronize()
    t_first = time.perf_counter()
    for i in range(TRAIN_STEPS):
        if i == 1:
            torch.cuda.synchronize()
            first_ms = (time.perf_counter() - t_first) * 1e3
            planned_first = F.plan_log()
            F.clear_plan_log()
            t0 = time.perf_counter()
        before = kernels.counts()
        state, met = step(state, batch)
        check_launches(f"phase 10 train step {i}", before, kernels.counts(), expect)
        losses.append(met["loss"])
    torch.cuda.synchronize()
    run_ms = (time.perf_counter() - t0) * 1e3
    check(F.plan_log() == (), f"phase 10: steps after the first planned {F.plan_log()}")
    losses = [float(v) for v in losses]
    check(all(math.isfinite(v) for v in losses), f"phase 10: non-finite loss {losses}")
    check(losses[-1] < losses[0], f"phase 10: the loss did not fall on a repeated batch: {losses}")
    step_ms = run_ms / (TRAIN_STEPS - 1)
    TRAIN_RECORD.update(losses=losses, step_ms=step_ms)
    split = device_split(lambda: step(state, batch))
    classes = device_classes(lambda: step(state, batch))
    peak = torch.cuda.max_memory_allocated()

    # The optimizer alone: AdamW's update over every parameter at lr 0 (m
    # and v move, the parameters do not), CUDA events.
    _, opt_update = make_optimizer(tc)
    zeros = {n: torch.zeros_like(p) for n, p in model.named_parameters()}
    opt_ms = time_ms(lambda: opt_update(zeros, state.opt_state, model, 0.0), reps=3)
    del zeros, state, model, batch
    torch.cuda.empty_cache()

    resume = resume_check(cfg, tc, lambda i: {k: v.cuda() for k, v in make_batch(dcfg, i).items()})
    print("train " + json.dumps({
        "config": cfg.name + " use_spectral_mixer", "layers": cfg.num_layers, "parameters": n_params,
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS, "compute": cfg.compute_dtype,
        "remat": cfg.remat, "optimizer": tc.optimizer, "losses": losses,
        "launches_per_step": expect, "plans_first_step": len(planned_first),
        "first_step_ms": first_ms, "step_ms": step_ms, "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ * 1e3 / step_ms,
        "fft_kernel_ms": split[0] if split else None, "other_device_ms": split[1] if split else None,
        "other_top": split[2] if split else None,
        "fft_kernel_share": split[0] / step_ms if split else None,
        "busy": (split[0] + split[1]) / step_ms if split else None, "device_ms_by_class": classes,
        "optimizer_ms": opt_ms, "peak_bytes": peak, "param_bytes": 4 * n_params,
        "float32_vs_float64_conv": f32, "resume": resume,
    }), flush=True)


def grad_phase(gen) -> None:
    """Phase 10: (a) the backward of every kind, (b) the mixer's gradients
    at full width, (c) training the full-width model."""
    for spec, shape in GRAD_CASES:
        grad_case(gen, spec, shape)
        torch.cuda.empty_cache()
    mixer_grad_case(gen)
    train_case(gen)


# ---------------------------------------------------------------------------
# phase 11: the MoE block, deepseek-moe-16b + spectral mixing served
# ---------------------------------------------------------------------------

#: Decode steps before the insert and after it: one stream flush (chunk 256)
#: falls after the insert.
MOE_FIRST_STEPS, MOE_STEPS = 32, 256


def moe_config():
    """deepseek-moe-16b with the paper-integration flag: ("spectral", "moe")
    × 14 at d_model 2048, 16/16 heads of 128, 64 experts top-6 and 2 shared
    of d_ff 1408, vocab 102400, Lf 1024."""
    return dataclasses.replace(get_config("deepseek-moe-16b"), use_spectral_mixer=True)


def moe_layers(model) -> list:
    return [block.moe for block in model.stack if block.kind == "moe"]


@contextlib.contextmanager
def routing_watch(model, every_call: bool = False):
    """Forward hooks on every MoE layer.  A call over more than one token (a
    prefill or a teacher-forced forward) records, in call order, the
    layer's top-k experts of each token (sorted), its dropped count and its
    capacity; with ``every_call`` each call's dropped count is also summed on
    the card (no sync).  Yields the records."""
    rec = {"calls": [], "dropped": torch.zeros((), dtype=torch.long, device=model.device)}

    def hook(layer, args, _out):
        if every_call:
            rec["dropped"] += layer.dropped
        if args[0].shape[1] > 1:
            r = layer.route(args[0])
            rec["calls"].append((r.idx.sort(-1).values, layer.dropped, r.capacity))

    handles = [m.register_forward_hook(hook) for m in moe_layers(model)]
    try:
        yield rec
    finally:
        for h in handles:
            h.remove()


@contextlib.contextmanager
def ranges(targets):
    """A ``record_function`` range around each (object, method name, label)
    of ``targets`` (instance attributes shadowing the methods; removed
    after).  An object's method listed twice is wrapped once."""
    from torch.profiler import record_function

    patched = []

    def wrap(obj, name, label):
        fn = getattr(obj, name)

        def run(*args, **kwargs):
            with record_function(label):
                return fn(*args, **kwargs)

        setattr(obj, name, run)
        patched.append((obj, name))

    seen = set()
    for obj, name, label in targets:
        if (id(obj), name) not in seen:
            seen.add((id(obj), name))
            wrap(obj, name, label)
    try:
        yield
    finally:
        for obj, name in patched:
            delattr(obj, name)


def scope_classes(model, fn, targets, names, classify) -> dict:
    """Device ms of one call of ``fn`` by class, from a ``torch.profiler``
    trace with the :func:`ranges` of ``targets`` and the ops' input shapes:
    the port's FFT kernels (by name: ``ctypes`` launches them outside any
    aten op); weight casts (kernels under an ``aten::_to_copy`` of a tensor
    shaped as one of the model's parameters); every other kernel an aten op
    launched in the class ``classify`` gives the labels of the ranges around
    that op, innermost first (one of ``names``).  ``unattributed`` is device
    time the trace did not link to an op; also the kernel launches, the
    top-level ``aten::`` ops of the call and each class's three largest
    kernels (names cut to 90 characters)."""
    from torch.profiler import ProfilerActivity, profile

    labels = {label for _, _, label in targets}
    shapes = {tuple(p.shape) for p in model.parameters()}
    torch.cuda.synchronize()
    with ranges(targets), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                                  record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    names = ("fft_kernels", "weight_casts") + tuple(names)
    out = {name: 0.0 for name in names}
    by_name = {name: {} for name in names}
    device_ms, launches, aten_ops = 0.0, 0, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if e.name not in labels:  # a range's device-side copy is no kernel
                device_ms += e.time_range.elapsed_us() / 1e3
                launches += 1
                if OUR_KERNEL.search(e.name):  # launched through ctypes: no aten op owns it
                    out["fft_kernels"] += e.time_range.elapsed_us() / 1e3
            continue
        chain, up = [], e.cpu_parent
        while up is not None:
            chain.append(up)
            up = up.cpu_parent
        if e.name.startswith("aten::") and not any(u.name.startswith("aten::") for u in chain):
            aten_ops += 1
        if not e.kernels:
            continue
        ops = [e] + chain  # innermost first
        cast = any(u.name == "aten::_to_copy" and u.input_shapes and tuple(u.input_shapes[0]) in shapes
                   for u in ops)
        key = "weight_casts" if cast else classify([u.name for u in ops if u.name in labels])
        for k in e.kernels:
            if k.name in labels or OUR_KERNEL.search(k.name):
                continue
            ms = k.duration / 1e3
            out[key] += ms
            kernel = k.name[:90]
            by_name[key][kernel] = by_name[key].get(kernel, 0.0) + ms
    out["unattributed"] = device_ms - sum(out.values())
    top = {key: dict(sorted(v.items(), key=lambda kv: -kv[1])[:3]) for key, v in by_name.items() if v}
    return {"device_ms": device_ms, "classes": out, "kernel_launches": launches, "top_level_aten_ops": aten_ops,
            "top_kernels": top}


def moe_targets(model) -> list:
    """Ranges around each MoE layer's route, dispatch, experts, combine and
    whole forward, its shared experts, and each attention mixer's score
    passes (``_attend``) and decode."""
    targets = []
    for block in model.stack:
        if block.kind == "moe":
            m = block.moe
            targets += [(m, name, f"moe.{name}") for name in ("route", "dispatch", "experts", "combine")]
            targets.append((m, "forward", "moe"))
            if hasattr(m, "shared"):
                targets.append((m.shared, "forward", "moe.shared"))
            targets += [(block.mixer, "_attend", "attn.scores"), (block.mixer, "decode", "attn.decode")]
    return targets


def moe_class(labels: list) -> str:
    """A kernel's class from the :func:`moe_targets` ranges around it."""
    inner = labels[0] if labels else None
    if inner in ("moe.experts", "moe.shared"):
        return "expert_products"
    if inner in ("moe", "moe.route", "moe.dispatch", "moe.combine"):
        return "routing_dispatch"
    return {"attn.scores": "attention_scores", "attn.decode": "attention_decode"}.get(inner, "other")


def moe_classes(model, fn) -> dict:
    """Device ms of one call of ``fn`` by class (:func:`scope_classes`):
    the FFT kernels, weight casts, expert products (the MoE's batched FFN
    and its shared experts), routing and dispatch (router, softmax, sort,
    cumsum, index copies, gathers, the weighting, the aux loss), the
    prefill's attention score passes, a decode step's attention
    (projections, rope, the KV write, scores), other."""
    return scope_classes(model, fn, moe_targets(model), ("expert_products", "routing_dispatch",
                         "attention_scores", "attention_decode", "other"), moe_class)


def topk_share(a: list, b: list) -> float:
    """The share of (token, layer) top-k sets that differ between two
    :func:`routing_watch` records of the same prefills."""
    check(len(a) == len(b), f"phase 11: {len(a)} and {len(b)} routed calls")
    differ = total = 0
    for (ia, _, _), (ib, _, _) in zip(a, b):
        differ += int((ia != ib).any(-1).sum())
        total += ia.shape[0] * ia.shape[1]
    return differ / total


def per_prefill(calls: list, layers: int) -> list:
    """Each prefill's dropped assignments (summed over its layers) and
    capacity, from a :func:`routing_watch` record."""
    return [{"dropped": sum(int(d) for _, d, _ in calls[i:i + layers]), "capacity": calls[i][2]}
            for i in range(0, len(calls), layers)]


def served_rows(rows, requests, outs, start_steps, label):
    """Each request's served logit rows (its prefill's and its slot's at
    every decode step), checked finite and greedy; returns them."""
    served = []
    for j, (p, slot, start) in enumerate(requests):
        out = outs[slot]
        want = 1 + start_steps - start
        check(len(out) == want, f"{label} request {j}: {len(out)} tokens, expected {want}")
        r = torch.cat([rows["prefill"][j]] + [rows["decode"][k][slot:slot + 1] for k in range(start, start + want - 1)])
        check(bool(torch.isfinite(r).all()), f"{label} request {j}: non-finite served logits")
        check(r.argmax(-1).tolist() == out, f"{label} request {j}: emitted tokens are not the greedy ones")
        served.append(r)
    return served


def moe_phase(gen) -> None:
    """Phase 11: deepseek-moe-16b + use_spectral_mixer built on the card at
    full width and served: (a) bf16 at the config's capacity, timed and
    profiled; (b) float32 at that capacity, the four prefills (the bf16
    gate's reference); (c) float32 with capacity_factor = E/k (no
    assignment can drop), every served logit row against a teacher-forced
    ``logits_fn``.  Launches exact."""
    cfg, dev = moe_config(), gen.device
    torch.cuda.reset_peak_memory_stats()
    model = DecoderLM(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    layers = len(moe_layers(model))
    check(len(model.stack) == cfg.num_layers == 2 * layers and model.stack[0].kind == "spectral",
          f"phase 11: {len(model.stack)} layers, {layers} MoE, of {cfg.num_layers}")
    print(f"phase 11: {cfg.name} + use_spectral_mixer, {n_params} parameters", flush=True)
    prompts = [torch.randint(4, cfg.vocab_size, (n,), device=dev, generator=gen) for n in SERVE_PROMPTS]
    late = torch.randint(4, cfg.vocab_size, (SERVE_LATE,), device=dev, generator=gen)
    requests = [(p, slot, 0) for slot, p in enumerate(prompts)] + [(late, len(prompts), MOE_FIRST_STEPS)]
    c, block = model.stack[0].mixer.grain
    at_start = kernels.counts()

    # (a) bf16 compute at the config's capacity: the timed and profiled session.
    rows16 = recording(model)
    with routing_watch(model) as routed16:
        sess = serve_session(model, prompts, late, MOE_FIRST_STEPS)
        flush_at = (c - 1 - MOE_FIRST_STEPS) % c  # steps to the first flush after the insert
        ms_a = timed_run(sess, flush_at - 1)
        step = moe_classes(model, lambda: sess.run(1))
        check(sess.state.caches[0].phase == c - 1, f"phase 11: phase {sess.state.caches[0].phase} before the flush")
        flush_ms = timed_run(sess, 1)
        rest = MOE_STEPS - flush_at - 1
        ms_b = timed_run(sess, rest)
    out16 = [sess.output(s) for s in range(SERVE_SLOTS)]
    insert_ms = sess.phase_s["insert"] * 1e3 / SERVE_SLOTS
    del sess, model.prefill, model.decode_step
    served_rows(rows16, requests, out16, MOE_FIRST_STEPS + MOE_STEPS, "phase 11 bf16")
    pre16 = rows16["prefill"]
    del rows16
    torch.cuda.empty_cache()

    # (b) float32 compute at the same capacity: the prefills only.
    m32 = DecoderLM(dataclasses.replace(cfg, compute_dtype="float32"), device="meta")
    m32.load_state_dict(model.state_dict(), assign=True)
    with routing_watch(m32) as routed32:
        pre32 = [m32.prefill(p[None])[0] for p in prompts + [late]]
    del m32
    errs16 = [full_err(a, b.double()) for a, b in zip(pre16, pre32)]
    flips = topk_share(routed16["calls"], routed32["calls"])
    torch.cuda.empty_cache()

    # (c) float32 compute, capacity_factor = E/k: nothing can drop.
    mc = DecoderLM(dataclasses.replace(cfg, compute_dtype="float32",
                                       capacity_factor=cfg.num_experts / cfg.top_k), device="meta")
    mc.load_state_dict(model.state_dict(), assign=True)
    rows32 = recording(mc)
    F.clear_plan_log()
    with routing_watch(mc, every_call=True) as routed_c:
        sess = serve_session(mc, prompts, late, MOE_FIRST_STEPS)
        sess.run(MOE_STEPS)
        check(F.plan_log() == (), f"phase 11: the warm session planned {F.plan_log()}")
        out32 = [sess.output(s) for s in range(SERVE_SLOTS)]
        del sess, mc.prefill, mc.decode_step
        served = served_rows(rows32, requests, out32, MOE_FIRST_STEPS + MOE_STEPS, "phase 11 float32")
        del rows32
        errs, seq_lens = [], []
        for (p, slot, _), row in zip(requests, served):
            seq = torch.cat([p, torch.tensor(out32[slot][:-1], device=dev)])[None]
            seq_lens.append(seq.shape[1])
            hidden = mc(seq)[0][0, len(p) - 1:]
            errs.append(full_err(row, mc.head(hidden, mc.embed.table)))
            del hidden
    dropped_c = int(routed_c["dropped"])
    agree = [sum(a == b for a, b in zip(out16[s], out32[s])) / len(out32[s]) for s in range(SERVE_SLOTS)]
    del served, mc
    torch.cuda.empty_cache()

    # Each prompt length's prefill at bf16, warm (CUDA events, median of 3).
    eng = Engine(model, ServeConfig(eos_id=cfg.vocab_size))
    g = eng.generator(0)
    prefill_ms = {
        n: time_ms(lambda p=p: eng.prefill(p[None], max_len=SERVE_MAX_LEN, generator=g), reps=3)
        for n, p in zip(SERVE_PROMPTS + (SERVE_LATE,), prompts + [late])
    }
    prefill = moe_classes(model, lambda: eng.prefill(prompts[0][None], max_len=SERVE_MAX_LEN, generator=g))
    check_launches("phase 11", at_start, kernels.counts(),
                   serve_expect(model, seq_lens, flushes=1, bare_prefills=1))
    step_ms = (ms_a + ms_b) / (flush_at - 1 + rest)
    peak = torch.cuda.max_memory_allocated()
    print("serve_moe " + json.dumps({
        "config": cfg.name + " use_spectral_mixer", "layers": len(model.stack), "moe_layers": layers,
        "parameters": n_params, "experts": cfg.num_experts, "top_k": cfg.top_k,
        "shared_experts": cfg.num_shared_experts, "slots": SERVE_SLOTS, "max_len": SERVE_MAX_LEN,
        "prompts": list(SERVE_PROMPTS), "late": SERVE_LATE, "steps": [MOE_FIRST_STEPS, MOE_STEPS],
        "chunk": c, "block": block,
        "prefill_dropped_bf16": per_prefill(routed16["calls"], layers),
        "prefill_dropped_float32": per_prefill(routed32["calls"], layers),
        "no_drop_run_dropped": dropped_c, "served_vs_teacher_forced": errs, "bf16_vs_float32_prefill": errs16,
        "topk_sets_differing_bf16_float32": flips, "bf16_float32_token_agreement": agree,
        "prefill_ms": prefill_ms, "insert_ms": insert_ms, "decode_ms_per_step": step_ms,
        "decode_tok_per_s": SERVE_SLOTS * 1e3 / step_ms, "flush_step_ms": flush_ms,
        "step_device": step, "step_busy": step["device_ms"] / step_ms,
        "prefill_device": prefill, "prefill_busy": prefill["device_ms"] / prefill_ms[SERVE_PROMPTS[0]],
        "peak_bytes": peak, "param_bytes": 4 * n_params, "param_share_of_peak": 4 * n_params / peak,
    }), flush=True)
    check(dropped_c == 0, f"phase 11: the capacity-factor E/k run dropped {dropped_c} assignments")
    for j, (e32, e16) in enumerate(zip(errs, errs16)):
        check(e32 <= SERVE_TOL, f"phase 11 request {j}: served vs teacher-forced {e32:.3e} > {SERVE_TOL}")
        check(e16 <= BF16_TOL, f"phase 11 request {j}: bf16 prefill vs float32 {e16:.3e} > {BF16_TOL}")
    del model, eng
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 12: the recurrent LMs served: zamba2-2.7b and xlstm-125m
# ---------------------------------------------------------------------------

#: Prompts admitted into an empty batch and the one inserted after
#: SERVE_FIRST_STEPS steps.  The chunk rule (at most one chunk of 256, or
#: whole chunks) puts 1024 where phase 8 has 1000.
RECURRENT_PROMPTS, RECURRENT_LATE = (4096, 1024, 37), 2048
#: A prompt the chunk rule refuses (``ValueError``).
REFUSED_PROMPT = 1000
#: Each served config at full width, and its parameter count (the
#: reference's ``init_unzipped`` has the same).
RECURRENT_CONFIGS = {"zamba2-2.7b": 2_422_670_240, "xlstm-125m": 197_730_112}
#: The prompt whose prefill is profiled: xlstm-125m's sLSTM loop makes a
#: 4096-token trace of about 330 000 ops, so it profiles its 1024.
PROFILED_PROMPT = {"zamba2-2.7b": 4096, "xlstm-125m": 1024}

RECURRENT_CLASSES = {"rec.proj": "projections", "rec.scan": "chunk_scan", "rec.slstm": "slstm_loop",
                     "rec.attn": "attention"}


def recurrent_targets(model) -> list:
    """Ranges around each layer's mixer (Mamba2's and mLSTM's forward and
    decode: the SSD or GLA chunk work, and a decode step's recurrence;
    sLSTM's: the loop over time; attention's), and inside them around the
    in and out projections, with each MLP: ``rec.proj``."""
    proj = {"mamba2": ("_in_proj", "_out"), "mlstm": ("_project", "_out"), "slstm": ("_in", "_out")}
    targets = []
    for block in model.stack:
        m = block.mixer
        label = {"mamba2": "rec.scan", "mlstm": "rec.scan", "slstm": "rec.slstm"}.get(block.kind, "rec.attn")
        targets += [(m, "forward", label), (m, "decode", label)]
        targets += [(m, name, "rec.proj") for name in proj.get(block.kind, ("_qkv", "_out"))]
        if hasattr(block, "mlp"):
            targets.append((block.mlp, "forward", "rec.proj"))
    return targets


def recurrent_classes(model, fn) -> dict:
    """Device ms of one call of ``fn`` by class (:func:`scope_classes`):
    weight casts, in and out projections and the MLPs, the SSD or GLA chunk
    work (a decode step's recurrence), the sLSTM loop, attention, other."""
    return scope_classes(model, fn, recurrent_targets(model),
                         ("projections", "chunk_scan", "slstm_loop", "attention", "other"),
                         lambda labels: RECURRENT_CLASSES[labels[0]] if labels else "other")


def admitted(s: int, chunk: int) -> int:
    """The longest length up to ``s`` the chunk rule admits."""
    return s if s <= chunk else s // chunk * chunk


def recurrent_case(arch: str, gen) -> None:
    """One recurrent LM built on the card at full width from a seed and
    served as phase 8 serves (prompts 4096, 1024, 37; 96 steps; a 2048
    prompt inserted; 416 steps): bf16 timed and profiled, then float32 on
    the same weights, every served float32 logit row against a
    teacher-forced ``logits_fn`` at the longest length the chunk rule
    admits, and the bf16 prefill logits against the float32 ones; a
    1000-token prompt refused."""
    t0 = time.perf_counter()
    cfg, dev = get_config(arch), gen.device
    torch.cuda.reset_peak_memory_stats()
    model = DecoderLM(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == RECURRENT_CONFIGS[arch] and len(model.stack) == len(cfg.pattern()),
          f"phase 12 {arch}: {n_params} parameters in {len(model.stack)} layers")
    print(f"phase 12: {arch}, {n_params} parameters, {len(model.stack)} layers", flush=True)
    prompts = [torch.randint(4, cfg.vocab_size, (n,), device=dev, generator=gen) for n in RECURRENT_PROMPTS]
    late = torch.randint(4, cfg.vocab_size, (RECURRENT_LATE,), device=dev, generator=gen)
    requests = [(p, slot, 0) for slot, p in enumerate(prompts)] + [(late, len(prompts), SERVE_FIRST_STEPS)]
    steps = SERVE_FIRST_STEPS + SERVE_STEPS

    # (a.1) bf16 compute (the config's): the timed and profiled session.
    rows16 = recording(model)
    sess = serve_session(model, prompts, late, SERVE_FIRST_STEPS)
    half = SERVE_STEPS // 2
    ms_a = timed_run(sess, half)
    step = recurrent_classes(model, lambda: sess.run(1))
    ms_b = timed_run(sess, SERVE_STEPS - half - 1)
    out16 = [sess.output(s) for s in range(SERVE_SLOTS)]
    insert_ms = sess.phase_s["insert"] * 1e3 / SERVE_SLOTS
    del sess, model.prefill, model.decode_step
    served_rows(rows16, requests, out16, steps, f"phase 12 {arch} bf16")
    pre16 = rows16["prefill"]
    del rows16
    torch.cuda.empty_cache()

    # (a.2) float32 compute on the same weights: the session, its prefills
    # the bf16 gate's reference, every served row against teacher forcing.
    m32 = DecoderLM(dataclasses.replace(cfg, compute_dtype="float32"), device="meta")
    m32.load_state_dict(model.state_dict(), assign=True)
    rows32 = recording(m32)
    sess = serve_session(m32, prompts, late, SERVE_FIRST_STEPS)
    sess.run(SERVE_STEPS)
    out32 = [sess.output(s) for s in range(SERVE_SLOTS)]
    del sess, m32.prefill, m32.decode_step
    served = served_rows(rows32, requests, out32, steps, f"phase 12 {arch} float32")
    errs16 = [full_err(a, b.double()) for a, b in zip(pre16, rows32["prefill"])]
    del rows32, pre16
    errs, forced, held = [], [], []
    for (p, slot, _), row in zip(requests, served):
        seq = torch.cat([p, torch.tensor(out32[slot][:-1], device=dev)])
        n = admitted(seq.shape[0], cfg.chunk_size)
        hidden = m32(seq[None, :n])[0][0, len(p) - 1:]
        ref = m32.head(hidden, m32.embed.table)
        forced.append(n)
        held.append(ref.shape[0])
        errs.append(full_err(row[:ref.shape[0]], ref))
        del hidden, ref
    agree = [sum(a == b for a, b in zip(out16[s], out32[s])) / len(out32[s]) for s in range(SERVE_SLOTS)]
    del served, m32
    torch.cuda.empty_cache()

    # Each prompt length's prefill at bf16, warm (CUDA events, median of 3),
    # one profiled, and the refused length.
    eng = Engine(model, ServeConfig(eos_id=cfg.vocab_size))
    g = eng.generator(0)
    lens = RECURRENT_PROMPTS + (RECURRENT_LATE,)
    prefill_ms = {n: time_ms(lambda p=p: eng.prefill(p[None], max_len=SERVE_MAX_LEN, generator=g), reps=3)
                  for n, p in zip(lens, prompts + [late])}
    prof = (prompts + [late])[lens.index(PROFILED_PROMPT[arch])]
    prefill = recurrent_classes(model, lambda: eng.prefill(prof[None], max_len=SERVE_MAX_LEN, generator=g))
    refused = None
    try:
        eng.prefill(prompts[0][None, :REFUSED_PROMPT], max_len=SERVE_MAX_LEN, generator=g)
    except ValueError as err:
        refused = str(err)
    extra = {}
    if "slstm" in cfg.pattern():
        # One sLSTM layer's loop over a 4096-token prompt (host-bound: CUDA
        # events bracket its launches).
        layer = next(block for block in model.stack if block.kind == "slstm").mixer
        h = torch.randn(1, RECURRENT_PROMPTS[0], cfg.d_model, device=dev, generator=gen).to(model.compute_dtype)
        extra["slstm_layer_ms_4096"] = time_ms(lambda: layer(h), reps=3)
        del h
    step_ms = (ms_a + ms_b) / (SERVE_STEPS - 1)
    peak = torch.cuda.max_memory_allocated()
    print("serve_recurrent " + json.dumps({
        "config": cfg.name, "layers": len(model.stack), "pattern_unit": list(find_unit(cfg.pattern())),
        "parameters": n_params, "slots": SERVE_SLOTS, "max_len": SERVE_MAX_LEN,
        "prompts": list(RECURRENT_PROMPTS), "late": RECURRENT_LATE, "steps": [SERVE_FIRST_STEPS, SERVE_STEPS],
        "chunk": cfg.chunk_size, "served_vs_teacher_forced": errs, "forced_lengths": forced,
        "rows_held": held, "bf16_vs_float32_prefill": errs16, "bf16_float32_token_agreement": agree,
        "refused_prefill": REFUSED_PROMPT, "refused_error": refused,
        "prefill_ms": prefill_ms, "insert_ms": insert_ms, "decode_ms_per_step": step_ms,
        "decode_tok_per_s": SERVE_SLOTS * 1e3 / step_ms, **extra,
        "step_device": step, "step_busy": step["device_ms"] / step_ms,
        "profiled_prefill": PROFILED_PROMPT[arch], "prefill_device": prefill,
        "prefill_busy": prefill["device_ms"] / prefill_ms[PROFILED_PROMPT[arch]],
        "peak_bytes": peak, "param_bytes": 4 * n_params, "seconds": time.perf_counter() - t0,
    }), flush=True)
    check(refused is not None and "chunk" in refused, f"phase 12 {arch}: a {REFUSED_PROMPT}-token prefill ran")
    for j, (e32, e16) in enumerate(zip(errs, errs16)):
        check(e32 <= SERVE_TOL, f"phase 12 {arch} request {j}: served vs teacher-forced {e32:.3e} > {SERVE_TOL}")
        check(e16 <= BF16_TOL, f"phase 12 {arch} request {j}: bf16 prefill vs float32 {e16:.3e} > {BF16_TOL}")
    del model, eng
    torch.cuda.empty_cache()


def recurrent_phase(gen) -> None:
    """Phase 12: zamba2-2.7b, then xlstm-125m (:func:`recurrent_case`); no
    FFT kernel launches and no plan is made."""
    F.clear_plan_log()
    at_start = kernels.counts()
    for arch in RECURRENT_CONFIGS:
        recurrent_case(arch, gen)
    check_launches("phase 12", at_start, kernels.counts(), {})
    check(F.plan_log() == (), f"phase 12 planned {F.plan_log()}")


# ---------------------------------------------------------------------------
# phase 13: the modality frontends: musicgen-large and qwen2-vl-72b served
# ---------------------------------------------------------------------------

#: musicgen-large's prompts of frame embeddings, one per slot; the decode
#: steps fed through ``embeds=``, then those fed through the token table.
AUDIO_PROMPTS = (4096, 2048, 1000, 37)
AUDIO_EMBED_STEPS, AUDIO_TABLE_STEPS = 64, 8
#: The running batch's stream phase is set to C − AUDIO_FLUSH_AT before the
#: prompts join it, so the stream flush falls at that step.
AUDIO_FLUSH_AT = 32
#: The plain musicgen-large: one prompt and its decode steps.
AUDIO_PLAIN_PROMPT, AUDIO_PLAIN_STEPS = 4096, 16
#: qwen2-vl-72b at every published width, its depth cut to 8 of 80 layers so
#: that the float32 weights (38.1 GB), a 4096 prefill and the bf16 casts fit
#: one 80 GB card.
VISION_LAYERS = 8
#: The vision grid (32 × 32 patches = frontend_len 1024), the text after it
#: in each slot's prompt, and the decode steps.
VISION_GRID, VISION_TEXT, VISION_STEPS = 32, (3072, 2048, 976, 37), 32
#: The engine's text-only session: prompts, the steps before and after a
#: late prompt joins.
VISION_ENGINE_PROMPTS, VISION_ENGINE_LATE, VISION_ENGINE_STEPS = (4096, 1000, 37), 2048, (32, 32)
INT8_TOL = 0.03  # int8 served logits vs the bf16-cache served ones, relative to max|ref| (the reference's bound)
MROPE_TOL = 1e-6  # M-RoPE ids equal to the positions vs standard RoPE, relative to max|ref|
#: Each served model and its parameter count (the reference's init has the same).
FRONTEND_PARAMS = {"musicgen-large use_spectral_mixer": 3_179_481_088, "musicgen-large": 3_229_812_736,
                   "qwen2-vl-72b": 9_512_820_736}

FRONTEND_CLASSES = {"fe.gemm": "gemms", "fe.scores": "attention_scores", "fe.decode": "attention_decode"}


def frontend_targets(model) -> list:
    """Ranges around each attention layer's score passes (``_attend``) and
    decode, and around every projection: attention's q/k/v and out, the
    spectral mixer's gate and out, each MLP and the head (``fe.gemm``)."""
    targets = [(model.head, "forward", "fe.gemm")]
    for block in model.stack:
        m = block.mixer
        if block.kind == "spectral":
            targets += [(m, "_in_gate", "fe.gemm"), (m, "_out", "fe.gemm")]
        else:
            targets += [(m, "_attend", "fe.scores"), (m, "decode", "fe.decode"), (m, "_qkv", "fe.gemm"),
                        (m, "_out", "fe.gemm")]
        targets.append((block.mlp, "forward", "fe.gemm"))
    return targets


def frontend_classes(model, fn) -> dict:
    """Device ms of one call of ``fn`` by class (:func:`scope_classes`):
    the FFT kernels, weight casts, GEMMs (projections, MLPs, head), the
    prefill's attention score passes, a decode step's attention (the KV
    write, scores, softmax), other."""
    return scope_classes(model, fn, frontend_targets(model),
                         ("gemms", "attention_scores", "attention_decode", "other"),
                         lambda labels: FRONTEND_CLASSES[labels[0]] if labels else "other")


def join(model, prefilled, max_len: int, phase=None):
    """One decode state of a slot per request from its prefill ((logits
    (1, vocab), natural-order caches, prompt length)): the caches in decode
    layout (``prepare_decode_caches``, the model's KV dtype) inserted at the
    slot by ``Engine.insert`` (a spectral state re-phased to the batch's
    phase; the empty batch's set to ``phase`` where given).  Returns (caches,
    t (B,))."""
    eng = Engine(model, ServeConfig(eos_id=model.cfg.vocab_size))
    state = eng.init_state(len(prefilled), max_len)
    if phase is not None:
        state = state._replace(caches=[c._replace(phase=phase) if isinstance(c, SpectralStreamCache) else c
                                       for c in state.caches])
    for slot, (logits, caches, n) in enumerate(prefilled):
        pres = PrefillResult(model.prepare_decode_caches(caches, max_len), logits.argmax(-1),
                             torch.full((1,), n, dtype=torch.long, device=model.device))
        state = eng.insert(state, pres, slot)
    return state.caches, state.lengths


def decode_run(model, caches, t, last, embeds=None, steps: int = 0, tokens=None, ids=None) -> tuple:
    """Decode from (caches, t (B,)): one step per column of ``embeds``
    (B, E, D) through ``embeds=``, then ``steps`` steps through the token
    table, each fed ``tokens[:, i]`` where given, else the greedy token of
    the last logits (``last`` (B, vocab) before the first); ``ids`` (B,)
    the slots' next M-RoPE id (text: one id in all three streams), advanced
    each step.  Returns (the steps' logits, the tokens fed (B, steps), ms
    of the embedding steps and of the table steps on the host clock, each
    run ending in a sync)."""
    rows, fed, ms = [], [], []
    for n, table in ((0 if embeds is None else embeds.shape[1], False), (steps, True)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            if table:
                tok = last.argmax(-1) if tokens is None else tokens[:, i]
                fed.append(tok)
                mp = None if ids is None else ids[:, None, None].expand(-1, 3, 1)
                last, caches = model.decode_step(tok, caches, t, mrope_positions=mp)
            else:
                last, caches = model.decode_step(None, caches, t, embeds=embeds[:, i:i + 1])
            rows.append(last)
            t = t + 1
            ids = None if ids is None else ids + 1
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return rows, torch.stack(fed, 1) if fed else None, ms[0], ms[1], caches, t


def slot_rows(pre, rows, j: int) -> torch.Tensor:
    """Slot ``j``'s served logit rows: its prefill's and every step's."""
    return torch.cat([pre[j]] + [r[j:j + 1] for r in rows])


def audio_expect(model, prefills, inserts: int, flushes: int, forced) -> dict:
    """Kernel → launches of the spectral layers: ``fft_conv`` at
    next_pow2(S + Lf − 1) for each prefill and teacher-forced forward of S
    positions (``prefills``, ``forced``), the stream lookahead for each
    prefill, insert (re-phase) and flush."""
    mixer = next(b.mixer for b in model.stack if b.kind == "spectral")
    lf, (_, block) = mixer.filter_len, mixer.grain
    conv = lambda s: rplans(next_pow2(s + lf - 1))  # noqa: E731
    looks = len(prefills) + inserts + flushes
    uses = [u for s in list(prefills) + list(forced) for u in conv(s)] + rplans(block, calls=(2 * looks, looks))
    layers = sum(b.kind == "spectral" for b in model.stack)
    return {k: v * layers for k, v in plans_launches(uses).items()}


def audio_case(gen, spectral: bool) -> None:
    """musicgen-large at full width and depth, plain or with
    ``use_spectral_mixer``, from seed 0: prompts of seeded bf16 frame
    embeddings, each prefilled and joined into one decode state (one slot
    each, its own ``t``), decoded through ``embeds=`` and then through the
    token table, at bf16 (timed, profiled), then at float32 on the same
    weights: every served logit row within 1e-3·max|ref| of a
    teacher-forced forward over the same frames (the table steps' frames
    the table's embedding of the fed tokens), the bf16 prefill logits
    within 5e-2·max|ref| of the float32 ones; launches exactly those of the
    spectral layers' plans, none planned in the warm float32 serve."""
    t0 = time.perf_counter()
    cfg, dev = dataclasses.replace(get_config("musicgen-large"), use_spectral_mixer=spectral), gen.device
    name = cfg.name + (" use_spectral_mixer" if spectral else "")
    torch.cuda.reset_peak_memory_stats()
    model = DecoderLM(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == FRONTEND_PARAMS[name] and len(model.stack) == cfg.num_layers == 48,
          f"phase 13 {name}: {n_params} parameters in {len(model.stack)} layers")
    print(f"phase 13: {name}, {n_params} parameters, {len(model.stack)} layers, pattern "
          f"{find_unit(cfg.pattern())} × {len(model.stack) // len(find_unit(cfg.pattern()))}", flush=True)
    lens = AUDIO_PROMPTS if spectral else (AUDIO_PLAIN_PROMPT,)
    e_steps, t_steps = (AUDIO_EMBED_STEPS, AUDIO_TABLE_STEPS) if spectral else (AUDIO_PLAIN_STEPS, 0)
    frames = [torch.randn(1, n, cfg.d_model, device=dev, generator=gen).to(torch.bfloat16) for n in lens]
    embeds = torch.randn(len(lens), e_steps, cfg.d_model, device=dev, generator=gen).to(torch.bfloat16)
    max_len = max(lens) + e_steps + t_steps
    c = model.stack[0].mixer.grain[0] if spectral else None
    phase = c - AUDIO_FLUSH_AT if spectral else None
    at_start = kernels.counts()

    def serve(m):
        pre = [m.prefill(frame_embeds=f) for f in frames]
        caches, t = join(m, [(lg, cc, f.shape[1]) for (lg, cc), f in zip(pre, frames)], max_len, phase)
        last = torch.cat([lg for lg, _ in pre])
        rows, fed, ms_e, ms_t, caches, t = decode_run(m, caches, t, last, embeds, t_steps)
        return [lg for lg, _ in pre], rows, fed, ms_e, ms_t, caches, t

    # bf16 compute (the config's): timed, a table step profiled.
    pre16, _, _, ms_e, ms_t, caches, t = serve(model)
    step = frontend_classes(model, lambda: model.decode_step(torch.zeros(len(lens), dtype=torch.long, device=dev),
                                                             caches, t))
    del caches, t
    torch.cuda.empty_cache()

    # float32 compute on the same weights: the served rows against teacher forcing.
    m32 = DecoderLM(dataclasses.replace(cfg, compute_dtype="float32"), device="meta")
    m32.load_state_dict(model.state_dict(), assign=True)
    F.clear_plan_log()
    pre32, rows32, fed, _, _, caches, _ = serve(m32)
    planned = F.plan_log()
    del caches
    errs, errs16, forced = [], [], []
    for j, f in enumerate(frames):
        row = slot_rows(pre32, rows32, j)
        check(bool(torch.isfinite(row).all()), f"phase 13 {name} slot {j}: non-finite served logits")
        seq = [f.float(), embeds[j:j + 1].float()]
        if fed is not None:
            check(fed[j].tolist() == row[e_steps:-1].argmax(-1).tolist(), f"phase 13 {name} slot {j}: not greedy")
            seq.append(m32.embed(fed[j:j + 1], torch.float32))
        seq = torch.cat(seq, dim=1)
        forced.append(seq.shape[1])
        hidden = m32(frame_embeds=seq)[0][0, f.shape[1] - 1:]
        errs.append(full_err(row, m32.head(hidden, m32.embed.table)))
        errs16.append(full_err(pre16[j], pre32[j].double()))
        del hidden, row
    del rows32, m32
    torch.cuda.empty_cache()

    # Each prompt's prefill at bf16, warm (CUDA events, median of 3), the longest profiled.
    prefill_ms = {f.shape[1]: time_ms(lambda f=f: model.prefill(frame_embeds=f), reps=3) for f in frames}
    prefill = frontend_classes(model, lambda: model.prefill(frame_embeds=frames[0]))
    steps = e_steps + t_steps
    if spectral:
        flushes = sum((phase + i) % c == c - 1 for i in range(steps))
        expect = audio_expect(model, [s for s in lens for _ in range(2 + 4)] + [lens[0]], 2 * len(lens),
                              2 * flushes, forced)
    else:
        flushes, expect = 0, {}
    check_launches(f"phase 13 {name}", at_start, kernels.counts(), expect)
    step_ms = ms_e / e_steps
    out = {
        "config": name, "layers": len(model.stack), "pattern_unit": list(find_unit(cfg.pattern())),
        "parameters": n_params, "slots": len(lens), "prompts": list(lens), "max_len": max_len,
        "embed_steps": e_steps, "table_steps": t_steps, "flushes_per_serve": flushes,
        "served_vs_teacher_forced": errs, "forced_lengths": forced, "bf16_vs_float32_prefill": errs16,
        "planned_when_warm": [str(p) for p in planned], "prefill_ms": prefill_ms,
        "decode_ms_per_step": step_ms, "decode_tok_per_s": len(lens) * 1e3 / step_ms,
        "table_ms_per_step": ms_t / t_steps if t_steps else None,
        "step_device": step, "step_busy": step["device_ms"] / step_ms,
        "prefill_device": prefill, "prefill_busy": prefill["device_ms"] / prefill_ms[lens[0]],
        "peak_bytes": torch.cuda.max_memory_allocated(), "param_bytes": 4 * n_params,
        "seconds": time.perf_counter() - t0,
    }
    print("serve_frontend " + json.dumps(out), flush=True)
    check(not planned, f"phase 13 {name}: the warm float32 serve planned {planned}")
    for j, (e32, e16) in enumerate(zip(errs, errs16)):
        check(e32 <= SERVE_TOL, f"phase 13 {name} slot {j}: served vs teacher-forced {e32:.3e} > {SERVE_TOL}")
        check(e16 <= BF16_TOL, f"phase 13 {name} slot {j}: bf16 prefill vs float32 {e16:.3e} > {BF16_TOL}")
    del model, frames, embeds
    torch.cuda.empty_cache()


def vision_ids(text: int, dev) -> torch.Tensor:
    """(1, 3, G² + text) M-RoPE ids by qwen2-vl's rule: the G × G grid's
    patch i at (0, i // G, i % G), then text position j at G + j in all
    three streams."""
    g = VISION_GRID
    i = torch.arange(g * g, device=dev)
    grid = torch.stack([torch.zeros_like(i), i // g, i % g])
    return torch.cat([grid, (g + torch.arange(text, device=dev)).expand(3, text)], dim=1)[None]


def vision_case(gen) -> None:
    """qwen2-vl-72b at full width, 8 of its 80 layers, from seed 0.  Each
    slot's prompt: a 32 × 32 grid of seeded bf16 vision embeddings, then
    text, with qwen2-vl's M-RoPE ids; prefilled, joined (each slot at its
    own ``t``) and decoded greedily with ids that continue the text's (so
    apart from the KV slot).  bf16 with the config's int8 cache: timed,
    profiled.  float32 with the cache in the compute dtype: every served
    row within 1e-3·max|ref| of teacher forcing (the head only at the
    checked positions); float32 with the int8 cache fed the same tokens:
    within 0.03·max|ref| of those rows; bf16 prefill within 5e-2·max|ref|
    of float32; M-RoPE ids equal to the positions give standard RoPE's
    logits.  Then the engine serves text-only prompts (standard RoPE, int8
    cache) at 4 slots with a late insert, bf16, timed.  No FFT launch and
    no plan."""
    t0 = time.perf_counter()
    cfg, dev = dataclasses.replace(get_config("qwen2-vl-72b"), num_layers=VISION_LAYERS), gen.device
    torch.cuda.reset_peak_memory_stats()
    model = DecoderLM(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == FRONTEND_PARAMS[cfg.name] and cfg.frontend_len == VISION_GRID ** 2,
          f"phase 13 {cfg.name}: {n_params} parameters")
    print(f"phase 13: {cfg.name} at {VISION_LAYERS} of its {get_config(cfg.name).num_layers} layers (the depth "
          f"cut; every width published: d_model {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of "
          f"{cfg.resolved_head_dim}, M-RoPE sections {cfg.mrope_sections}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, KV cache {cfg.kv_cache_dtype}, theta {cfg.rope_theta:g}), {n_params} parameters",
          flush=True)
    grid = VISION_GRID ** 2
    reqs = []
    for text in VISION_TEXT:
        toks = torch.randint(4, cfg.vocab_size, (1, grid + text), device=dev, generator=gen)
        ve = torch.randn(1, grid, cfg.d_model, device=dev, generator=gen).to(torch.bfloat16)
        reqs.append({"tokens": toks, "vision_embeds": ve, "mrope_positions": vision_ids(text, dev)})
    next_ids = torch.tensor([VISION_GRID + text for text in VISION_TEXT], device=dev)
    max_len = grid + max(VISION_TEXT) + VISION_STEPS + 1
    lens = [r["tokens"].shape[1] for r in reqs]
    F.clear_plan_log()
    at_start = kernels.counts()

    def serve(m, prefilled, tokens=None):
        caches, t = join(m, [(lg, cc, n) for (lg, cc), n in zip(prefilled, lens)], max_len)
        last = torch.cat([lg for lg, _ in prefilled])
        return decode_run(m, caches, t, last, steps=VISION_STEPS, tokens=tokens, ids=next_ids)

    # bf16 compute, the config's int8 cache: timed, a step profiled.
    pre16 = [model.prefill(**r) for r in reqs]
    _, _, _, ms16, caches, t = serve(model, pre16)
    check(caches[0].k.dtype == torch.int8, "phase 13: the bf16 serve's cache is not int8")
    ids = next_ids + VISION_STEPS
    step = frontend_classes(model, lambda: model.decode_step(torch.zeros(len(reqs), dtype=torch.long, device=dev),
                                                             caches, t, mrope_positions=ids[:, None, None].expand(-1, 3, 1)))
    pre16 = [lg for lg, _ in pre16]
    del caches, t
    torch.cuda.empty_cache()

    # float32 compute: the cache in the compute dtype, then int8 fed the same tokens.
    m32 = DecoderLM(dataclasses.replace(cfg, compute_dtype="float32", kv_cache_dtype="bf16"), device="meta")
    m32.load_state_dict(model.state_dict(), assign=True)
    m8 = DecoderLM(dataclasses.replace(cfg, compute_dtype="float32"), device="meta")
    m8.load_state_dict(model.state_dict(), assign=True)
    pre32 = [m32.prefill(**r) for r in reqs]
    rows32, fed, _, _, caches, _ = serve(m32, pre32)
    check(caches[0].k.dtype == torch.float32, "phase 13: the float32 serve's cache is not float32")
    del caches
    rows8, _, _, _, caches, _ = serve(m8, pre32, tokens=fed)
    check(caches[0].k.dtype == torch.int8, "phase 13: the int8 serve's cache is not int8")
    del caches
    pre32 = [lg for lg, _ in pre32]
    errs, errs8, errs16 = [], [], []
    for j, r in enumerate(reqs):
        row = slot_rows(pre32, rows32, j)
        check(bool(torch.isfinite(row).all()), f"phase 13 qwen2-vl slot {j}: non-finite served logits")
        check(fed[j].tolist() == row[:-1].argmax(-1).tolist(), f"phase 13 qwen2-vl slot {j}: not greedy")
        ids_j = torch.cat([r["mrope_positions"],
                           (next_ids[j] + torch.arange(VISION_STEPS, device=dev)).expand(1, 3, -1)], dim=2)
        hidden = m32(torch.cat([r["tokens"], fed[j:j + 1]], dim=1), vision_embeds=r["vision_embeds"],
                     mrope_positions=ids_j)[0][0, lens[j] - 1:]
        errs.append(full_err(row, m32.head(hidden, m32.embed.table)))
        errs8.append(full_err(torch.cat([x[j:j + 1] for x in rows8]), torch.cat([x[j:j + 1] for x in rows32])))
        errs16.append(full_err(pre16[j], pre32[j].double()))
        del hidden, row
    # M-RoPE ids equal to the positions: standard RoPE's logits.
    text = reqs[0]["tokens"][:, grid:]
    same = torch.arange(text.shape[1], device=dev).expand(1, 3, -1)
    mrope_err = full_err(m32.prefill(text, mrope_positions=same)[0], m32.prefill(text)[0].double())
    del rows32, rows8, m32, m8
    torch.cuda.empty_cache()

    # Each prompt's prefill at bf16, warm (CUDA events, median of 3), the longest profiled.
    prefill_ms = {n: time_ms(lambda r=r: model.prefill(**r), reps=3) for n, r in zip(lens, reqs)}
    prefill = frontend_classes(model, lambda: model.prefill(**reqs[0]))

    # The engine: text-only prompts (standard RoPE), the int8 cache, bf16.
    prompts = [torch.randint(4, cfg.vocab_size, (n,), device=dev, generator=gen) for n in VISION_ENGINE_PROMPTS]
    late = torch.randint(4, cfg.vocab_size, (VISION_ENGINE_LATE,), device=dev, generator=gen)
    first, after = VISION_ENGINE_STEPS
    rows = recording(model)
    sess = serve_session(model, prompts, late, first)
    engine_ms = timed_run(sess, after)
    outs = [sess.output(s) for s in range(SERVE_SLOTS)]
    check(sess.state.caches[0].k.dtype == torch.int8, "phase 13: the engine's cache is not int8")
    del sess, model.prefill, model.decode_step
    requests = [(p, slot, 0) for slot, p in enumerate(prompts)] + [(late, len(prompts), first)]
    served_rows(rows, requests, outs, first + after, "phase 13 qwen2-vl engine")
    del rows
    check_launches("phase 13 qwen2-vl-72b", at_start, kernels.counts(), {})
    planned = F.plan_log()
    step_ms = ms16 / VISION_STEPS
    out = {
        "config": cfg.name, "layers": len(model.stack), "layers_of": get_config(cfg.name).num_layers,
        "parameters": n_params, "slots": len(reqs), "vision_grid": [VISION_GRID, VISION_GRID],
        "text": list(VISION_TEXT), "prompts": lens, "next_mrope_ids": next_ids.tolist(), "max_len": max_len,
        "steps": VISION_STEPS, "served_vs_teacher_forced": errs, "int8_vs_bf16_cache_served": errs8,
        "bf16_vs_float32_prefill": errs16, "mrope_equal_ids_vs_rope": mrope_err, "prefill_ms": prefill_ms,
        "decode_ms_per_step": step_ms, "decode_tok_per_s": len(reqs) * 1e3 / step_ms,
        "step_device": step, "step_busy": step["device_ms"] / step_ms,
        "prefill_device": prefill, "prefill_busy": prefill["device_ms"] / prefill_ms[lens[0]],
        "engine_prompts": list(VISION_ENGINE_PROMPTS), "engine_late": VISION_ENGINE_LATE,
        "engine_steps": [first, after], "engine_ms_per_step": engine_ms / after,
        "engine_tok_per_s": SERVE_SLOTS * after * 1e3 / engine_ms, "planned": [str(p) for p in planned],
        "peak_bytes": torch.cuda.max_memory_allocated(), "param_bytes": 4 * n_params,
        "seconds": time.perf_counter() - t0,
    }
    print("serve_frontend " + json.dumps(out), flush=True)
    check(not planned, f"phase 13 qwen2-vl-72b planned {planned}")
    check(mrope_err <= MROPE_TOL, f"phase 13: M-RoPE ids equal to the positions vs RoPE {mrope_err:.3e}")
    for j, (e32, e8, e16) in enumerate(zip(errs, errs8, errs16)):
        check(e32 <= SERVE_TOL, f"phase 13 qwen2-vl slot {j}: served vs teacher-forced {e32:.3e} > {SERVE_TOL}")
        check(e8 <= INT8_TOL, f"phase 13 qwen2-vl slot {j}: int8 vs bf16-cache served {e8:.3e} > {INT8_TOL}")
        check(e16 <= BF16_TOL, f"phase 13 qwen2-vl slot {j}: bf16 prefill vs float32 {e16:.3e} > {BF16_TOL}")
    del model
    torch.cuda.empty_cache()


def frontend_phase(gen) -> None:
    """Phase 13: musicgen-large with spectral mixing, the plain
    musicgen-large, then qwen2-vl-72b (:func:`audio_case`,
    :func:`vision_case`)."""
    audio_case(gen, spectral=True)
    audio_case(gen, spectral=False)
    vision_case(gen)


# ---------------------------------------------------------------------------
# phase 14: the distributed pencil FFT
# ---------------------------------------------------------------------------

#: A rank's shard vs torch.fft in complex128 of the global input, sliced,
#: relative to max|ref|: the reference's distributed tolerance.  Round trips
#: and Parseval's gradient are held to it too, relative to max|x|.
PENCIL_TOL = 5e-5
CONV_SHARDED_TOL = 1e-4  # pconv_os_sharded vs torch.fft in float64 (the reference's pconv test)
PENCIL_WORLD = 4
#: Seconds: the four ranks' whole run (a hung rank is killed and fails the
#: phase), and each collective of a group.
PENCIL_TIMEOUT = 300
GROUP_TIMEOUT = 120

#: (a) one rank over NCCL in this process, at fftbench's own sizes: pod_16m
#: (2^24 × 32, 4 GiB of planes) and sar_4kx8k (4096 × 8192 × 32).
POD_16M = (1 << 24, 32)
SAR_SCENE = (4096, 8192, 32)
#: (b) four ranks on the one card over gloo, whose wire is the host's: the
#: full lengths, batches cut where listed.
POD_1M = (1 << 20, 64)  # pod_1m whole
POD_16M_CUT = (1 << 24, 4)  # pod_16m's batch 32 → 4
UNPACKED = (1 << 20, 8)  # pod_1m's batch 64 → 8
SAR_CUT = (4096, 8192, 4)  # sar_4kx8k's batch 32 → 4
CONV_512K = (32, 1 << 19, 4097)  # conv_512k: (32, 2^19) ⊛ 4097 taps, whole
GRAD_CUT = (1 << 20, 2)  # pod_1m's batch 64 → 2


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def pencil_launches(pl, natural: bool) -> dict:
    """Kernel → launches of one call of pencil plan ``pl``: the local plan
    (one rank in natural order), else the column plan once per chunk and
    the row plan once."""
    if pl.d <= 1 and natural:
        return launches_per_call(pl.local_plan)
    expect = launches_per_call(pl.plan_n1, pl.a2a_chunks if pl.d > 1 else 1)
    for k, c in launches_per_call(pl.plan_n2).items():
        expect[k] = expect.get(k, 0) + c
    return expect


def pencil_perm(X, n1: int, n2: int):
    """The natural spectrum in pencil layout: [k1, k2] holds X[k1 + n1·k2]."""
    return X.reshape(*X.shape[:-1], n2, n1).transpose(-1, -2).reshape(X.shape)


def chunked_err(got, x, ref_fn, pick, rows: int = 4) -> float:
    """max|Δ| / max|ref| of the planes ``got`` against ``pick(ref_fn(x))``
    (x the global planes in complex128, ``pick`` this rank's slice), over
    the leading axis in chunks of ``rows``."""
    err = scale = 0.0
    for i in range(0, x[0].shape[0], rows):
        want = pick(ref_fn(torch.complex(x[0][i:i + rows].double(), x[1][i:i + rows].double())))
        g = torch.complex(got[0][i:i + rows].double(), got[1][i:i + rows].double())
        err = max(err, (g - want).abs().max().item())
        scale = max(scale, want.abs().max().item())
        del want, g
    return err / scale


def planes_err(got, want) -> float:
    """max|Δ| / max|want| over split planes."""
    err, scale = max_err(got, want)
    return err / scale


def wall_ms(fn, reps: int = 2) -> float:
    """Median host-clock ms of ``fn`` ending in a device synchronisation,
    the ranks lined up by a barrier first (a gloo collective waits on the
    host, so CUDA events would not see it)."""
    times = []
    for _ in range(reps):
        if dist.get_world_size() > 1:
            dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


class PencilRun:
    """Phase 14's cases on one rank: each call held to its launches and
    collectives, its error, its peak device memory beyond its inputs, its
    ms per call, the ms of its local stages alone (CUDA events) and its
    local bound; ``records`` collects them."""

    def __init__(self, rank: int, world: int, smi: str):
        self.rank, self.world, self.smi = rank, world, smi
        self.records = []
        self.peak = 0  # the rank's peak allocated bytes over its calls

    def shard(self, t, axis: int = -1):
        """This rank's block of ``t`` along ``axis`` (one rank: ``t`` itself)."""
        if self.world == 1:
            return t
        n = t.shape[axis] // self.world
        return t.narrow(axis, self.rank * n, n).contiguous()

    def call(self, label: str, run, expect: dict, a2a: int, gather: int = 0):
        """One call held to exactly ``expect`` kernel launches, ``a2a``
        all-to-alls and ``gather`` all-gathers; returns its output and peak."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        before, coll = kernels.counts(), D.counts()
        y = run()
        torch.cuda.synchronize()
        tag = f"phase 14 {label} rank {self.rank}"
        check_launches(tag, before, kernels.counts(), expect)
        got = D.counts()
        moved = (got["all_to_all"] - coll["all_to_all"], got["all_gather"] - coll["all_gather"])
        check(moved == (a2a, gather), f"{tag}: collectives (all_to_all, all_gather) {moved}, "
                                      f"expected {(a2a, gather)}")
        self.peak = max(self.peak, torch.cuda.max_memory_allocated())
        return y, torch.cuda.max_memory_allocated() - base

    def record(self, label: str, n: int, batch: int, run, errs: dict, peak: int, local, bound_bytes: float,
               a2a: int, slab=None, **extra) -> None:
        """Time the case (ms per call; the local stages alone; one packed
        all-to-all of the rank's slab) and keep its line."""
        call_ms = wall_ms(run) if self.world > 1 else time_ms(run, reps=3, warmup=0)
        local_ms = time_ms(local, reps=3, warmup=1)
        a2a_ms = None
        if slab is not None and self.world > 1:
            z = torch.zeros(slab, device="cuda")
            a2a_ms = wall_ms(lambda: D._a2a(z, None, -1, -2)())
            del z
        for name, err in errs.items():
            check(err <= (CONV_SHARDED_TOL if name == "conv" else PENCIL_TOL),
                  f"phase 14 {label} rank {self.rank}: {name} error {err:.3e}")
        self.records.append({
            "case": label, "world": self.world, "rank": self.rank, "n": n, "batch": batch, **errs,
            "collectives": a2a, "ms": call_ms, "local_ms": local_ms, "a2a_one_ms": a2a_ms,
            "local_bound_ms": bound_bytes / HBM_BYTES_PER_S * 1e3, "peak_bytes": peak, "card": self.smi,
            **extra,
        })


def pencil_local(pl, b: int, natural: bool, gen):
    """The local stages of one call of ``pl`` on fresh planes of its shapes,
    with no collective: the column transform per chunk with its twiddle
    window, then the row transform (one rank in natural order: the local
    plan)."""
    if pl.d <= 1 and natural:
        x = planes(gen, b, pl.n)
        return lambda: pl.local_plan.apply_planes(*x)
    qk = pl.q // pl.a2a_chunks if pl.d > 1 else pl.n2
    cols = planes(gen, b, pl.n1, qk)
    rows = planes(gen, b, pl.p, pl.n2)

    def run():
        for c in range(pl.a2a_chunks if pl.d > 1 else 1):
            yr, yi = pl.plan_n1.apply_planes(*cols)
            fft_torch.cmul(yr, yi, *twiddle.twiddle_window(pl.n1, pl.n2, pl.inverse, col_start=c * qk,
                                                           col_count=qk, device="cuda"))
        pl.plan_n2.apply_planes(*rows)
    return run


def pencil_1d(run_: PencilRun, gen, n: int, b: int, *, chunks=None, pack=None, cases=("nat", "pen")) -> None:
    """pfft natural and pencil and their inverses on this rank's shard of a
    seeded global (b, n) signal, each against torch.fft in complex128."""
    d, lo = run_.world, run_.rank * (n // run_.world)
    hi = lo + n // d
    x = planes(gen, b, n)  # the same global signal on every rank
    mine = (run_.shard(x[0]), run_.shard(x[1]))
    kw = dict(chunks=chunks, pack=pack, tune="off")
    tag = f"n={n} B={b}" + (f" K={chunks}" if chunks else "") + (" unpacked" if pack is False else "")
    for case in cases:
        natural = case == "nat"
        fwd = D.plan_pencil(n, d, natural_order=natural, **kw)
        inv = D.plan_pencil(n, d, inverse=True, natural_order=natural, **kw)
        y, peak = run_.call(f"pfft {case} {tag}", lambda: D.pfft(*mine, pplan=fwd, natural_order=natural),
                            pencil_launches(fwd, natural), fwd.a2a_count(natural))
        if natural:
            pick = (lambda X: X[..., lo:hi])
        else:
            pick = (lambda X: pencil_perm(X, fwd.n1, fwd.n2)[..., lo:hi])
        err = chunked_err(y, x, torch.fft.fft, pick)
        rep = rl.pencil_report(n, d, b, n1=fwd.n1, n2=fwd.n2, pack=fwd.pack, chunks=fwd.a2a_chunks,
                               natural_order=natural)
        slab = (2, b, fwd.p, fwd.n2)
        run_.record(f"pfft {case} {tag}", n, b, lambda: D.pfft(*mine, pplan=fwd, natural_order=natural),
                    {"rel_err": err}, peak, pencil_local(fwd, b, natural, gen), rep["local_hbm_bytes"],
                    fwd.a2a_count(natural), slab, factors=[fwd.n1, fwd.n2], K=fwd.a2a_chunks, pack=fwd.pack)
        z, zpeak = run_.call(f"pifft {case} {tag}", lambda: D.pifft(*y, pplan=inv, from_pencil=not natural),
                             pencil_launches(inv, natural), inv.a2a_count(natural))
        rt = planes_err(z, mine)
        run_.record(f"pifft {case} {tag}", n, b, lambda: D.pifft(*y, pplan=inv, from_pencil=not natural),
                    {"roundtrip_rel_err": rt}, zpeak, pencil_local(inv, b, natural, gen),
                    rep["local_hbm_bytes"], inv.a2a_count(natural), slab)
        del y, z
    del x, mine
    torch.cuda.empty_cache()


def pencil_2d(run_: PencilRun, gen, n1: int, n2: int, b: int) -> None:
    """pfft2d on this rank's rows of a seeded global (b, n1, n2) image
    against torch.fft.fft2 in complex128."""
    x = planes(gen, b, n1, n2)
    mine = (run_.shard(x[0], -2), run_.shard(x[1], -2))
    p = n1 // run_.world
    joint = F.plan(F.FFTSpec(n2, kind="fft2", n2=n1))
    a2a = 2 if run_.world > 1 else 0
    label = f"pfft2d {n1}x{n2} B={b}"
    y, peak = run_.call(label, lambda: D.pfft2d(*mine, n1=n1, n2=n2), launches_per_call(joint), a2a)
    err = chunked_err(y, x, torch.fft.fft2, lambda X: X[..., run_.rank * p:(run_.rank + 1) * p, :], rows=1)
    del x, y
    torch.cuda.empty_cache()
    # The local stages alone: the rows on this rank's slab, the columns on
    # its (n1, n2 / d) slab (one rank: the same planes).
    cols = mine if run_.world == 1 else planes(gen, b, n1, n2 // run_.world)
    bound = rl.fft_pass_report(n2, b, n2=n1)["modeled_hbm_bytes"] / run_.world
    run_.record(label, n2, b, lambda: D.pfft2d(*mine, n1=n1, n2=n2), {"rel_err": err}, peak,
                lambda: (joint.apply_rows(*mine), joint.apply_cols(*cols)), bound, a2a, (2, b, p, n2), n1=n1)
    del mine, cols
    torch.cuda.empty_cache()


def pencil_world1(gen, smi: str) -> list:
    """Phase 14 (a): one rank over NCCL in this process at fftbench's
    sizes; the plans collapse to the local program with 0 collectives."""
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT))
    try:
        run_ = PencilRun(0, 1, smi)
        pencil_1d(run_, gen, *POD_16M)
        pencil_2d(run_, gen, *SAR_SCENE)
    finally:
        dist.destroy_process_group()
    return run_.records


def gloo_cuda_probe(phase: str, rank: int, world: int, ops: tuple) -> None:
    """A gloo rank's first collectives, ``ops``, on CUDA tensors.  A torch
    build whose gloo refuses them fails the phase (the error goes to stderr
    as well): the ranks never fall back to the host's tensors."""
    x = torch.arange(world, dtype=torch.float32, device="cuda")
    calls = {"all_to_all_single": lambda: dist.all_to_all_single(torch.empty_like(x), x),
             "all_reduce": lambda: dist.all_reduce(x.clone()),
             "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(x.new_empty(1), x),
             "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(x.new_empty(world * world), x)}
    for op in ops:
        try:
            calls[op]()
        except RuntimeError as err:
            msg = f"{phase} rank {rank}: gloo refused a CUDA tensor in {op}: {type(err).__name__}: {err}"
            print(msg, file=sys.stderr, flush=True)
            raise SmokeFailure(msg) from err


def pencil_rank_cases(rank: int, world: int, port: int, smi: str) -> dict:
    """Phase 14 (b) on one rank: its cases, its launches and collectives,
    and each distinct kernel call it made against its plain version (its
    "kernel_check" lines, printed from this process)."""
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT))
    try:
        gloo_cuda_probe("phase 14", rank, world, ("all_to_all_single",))
        gen = torch.Generator(device="cuda").manual_seed(14)  # the same global inputs on every rank
        run_ = PencilRun(rank, world, smi)
        with recorded_calls() as seen:
            kernels.reset_counts()
            D.reset_counts()
            pencil_1d(run_, gen, *POD_1M)
            pencil_1d(run_, gen, *POD_16M_CUT)
            for k in (2, 4):
                pencil_1d(run_, gen, *POD_1M, chunks=k, cases=("nat",))
            pencil_1d(run_, gen, *UNPACKED, pack=False, cases=("nat",))
            pencil_2d(run_, gen, *SAR_CUT)
            pencil_conv(run_, gen)
            pencil_grad(run_, gen)
            launches, collectives = kernels.counts(), D.counts()
        # Each distinct kernel call of this rank against its plain version
        # ("kernel_check ... distributed rank r path #i" lines).
        path_kernel_rows(f"distributed rank {rank}", seen, launches, gen, timed=False)
        return {"records": run_.records, "launches": launches, "collectives": collectives,
                "peak_bytes": run_.peak}
    finally:
        dist.destroy_process_group()


def pencil_conv(run_: PencilRun, gen) -> None:
    """pconv_os_sharded at conv_512k with the modelled block, against the
    same causal convolution through torch.fft in float64."""
    b, L, taps = CONV_512K
    x = torch.randn(b, L, device="cuda", generator=gen)
    h = torch.randn(taps, device="cuda", generator=gen) / math.sqrt(taps)
    block = tuning.modeled_block(L, taps, b, "cuda")
    expect = plans_launches(rplans(block, calls=(2, 1)))
    y, peak = run_.call(f"pconv_os_sharded ({b}, {L}) * {taps} block={block}",
                        lambda: D.pconv_os_sharded(x, h, tune="model"), expect, 0, 1 if run_.world > 1 else 0)
    check(tuple(y.shape) == (b, L), f"phase 14 pconv_os_sharded: output {tuple(y.shape)}")
    ref = lib_conv(x.double(), h.double(), next_pow2(L + taps - 1), L)
    err = full_err(y, ref)
    del ref
    step = block - (taps - 1)
    blocks = -(-L // step)
    nb = -(-blocks // run_.world) * run_.world  # pconv_os_sharded's padded block count
    frames = overlap.frame_signal(x, block, step, nb)[..., : nb // run_.world, :]
    Hr, Hi = overlap.filter_spectrum(h, block)
    bound = rl.conv_report(L, taps, b, block=block)["overlap_save"]["hbm_bytes"] / run_.world
    run_.record(f"pconv_os_sharded ({b}, {L}) * {taps} block={block}", L, b,
                lambda: D.pconv_os_sharded(x, h, tune="model"), {"conv": err}, peak,
                lambda: overlap.conv_frames(frames, Hr, Hi, overlap=taps - 1), bound,
                1 if run_.world > 1 else 0, None, block=block, all_gather=run_.world > 1)
    del x, y, frames
    torch.cuda.empty_cache()


def pencil_grad(run_: PencilRun, gen) -> None:
    """Parseval through the pencil schedule: d/dx Σ|FFT(x)|² = 2n·x, the
    backward running each local plan the other way and each all-to-all in
    reverse."""
    n, b = GRAD_CUT
    x = run_.shard(torch.randn(b, n, device="cuda", generator=gen)).requires_grad_()
    pl = D.plan_pencil(n, run_.world, tune="off")
    fwd = pencil_launches(pl, True)

    def run():
        yr, yi = D.pfft(x, torch.zeros_like(x), pplan=pl)
        (yr.square().sum() + yi.square().sum()).backward()
        return x.grad

    g, peak = run_.call(f"grad pfft n={n} B={b}", run, {k: 2 * v for k, v in fwd.items()},
                        2 * pl.a2a_count(True))
    want = 2 * n * x.detach()
    err = ((g - want).abs().max() / want.abs().max()).item()
    x.grad = None
    rep = rl.pencil_report(n, run_.world, b, n1=pl.n1, n2=pl.n2)
    run_.record(f"grad pfft n={n} B={b}", n, b, run, {"grad_rel_err": err}, peak,
                pencil_local(pl, b, True, gen), 2 * rep["local_hbm_bytes"], 2 * pl.a2a_count(True))
    x.grad = None


def rank_main(cases, rank: int, world: int, port: int, *args) -> None:
    """Entry of one spawned rank: ``cases(rank, world, port, *args[:-1])``'s
    result, or its failure, on the queue ``args[-1]``."""
    try:
        args[-1].put((rank, cases(rank, world, port, *args[:-1])))
    except Exception as err:  # the parent fails the phase with this rank's traceback
        args[-1].put((rank, {"error": f"{type(err).__name__}: {err}", "trace": traceback.format_exc()}))


def spawn_ranks(phase: str, cases, args: tuple, world: int, timeout: float) -> dict:
    """``world`` spawned ranks on this card, each running ``cases(rank,
    world, port, *args)`` (a gloo group on ``tcp://localhost:port``); each
    rank's result.  A rank that fails fails the phase; one that hangs is
    killed at ``timeout`` seconds."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=rank_main, args=(cases, r, world, port, *args, results), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.monotonic() + timeout
    try:
        while len(got) < world:
            try:
                rank, res = results.get(timeout=5)
                got[rank] = res
                continue
            except queue.Empty:
                pass
            dead = [r for r, p in enumerate(procs) if r not in got and p.exitcode is not None]
            check(not dead, f"{phase}: ranks {dead} exited ({[procs[r].exitcode for r in dead]}) with no result")
            check(time.monotonic() < deadline,
                  f"{phase}: ranks {sorted(set(range(world)) - set(got))} hung past {timeout} s")
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    for r in sorted(got):
        check("error" not in got[r], f"{phase} rank {r} failed: {got[r].get('error')}\n{got[r].get('trace')}")
    return got


def pencil_phase(gen) -> dict:
    """Phase 14: (a) one rank over NCCL in this process at fftbench's sizes,
    then (b) four ranks on this card over gloo; returns the ranks' kernel
    launches (this process counts its own)."""
    smi = card_line()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    for rec in pencil_world1(gen, smi):
        print("pencil " + json.dumps(rec), flush=True)
    print(f"phase 14 (a): {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn_ranks("phase 14", pencil_rank_cases, (smi,), PENCIL_WORLD, PENCIL_TIMEOUT)
    launches = {}
    for r in sorted(ranks):
        res = ranks[r]
        for rec in res["records"]:
            print("pencil " + json.dumps(rec), flush=True)
        print("pencil_rank " + json.dumps({"rank": r, "launches": res["launches"],
                                           "collectives": res["collectives"], "peak_bytes": res["peak_bytes"]}),
              flush=True)
        for key, count in res["launches"].items():
            launches[key] = launches.get(key, 0) + count
    for kernel in PENCIL_RANK_KERNELS:
        check(launches.get(kernel, 0) > 0, f"phase 14: the ranks launched no {kernel}")
    same = [ranks[r]["launches"] == ranks[0]["launches"] for r in sorted(ranks)]
    check(all(same), f"phase 14: the ranks launched different kernels: {[ranks[r]['launches'] for r in ranks]}")
    print(f"phase 14 (b): {time.perf_counter() - t0:.1f} s (gloo: the host's wire, not NVLink)", flush=True)
    return launches


def distributed_path(gen) -> dict:
    """Phase 14 as one path: the counts at 0, :func:`pencil_phase`, every
    kernel of the path launched and no plain version; then each distinct
    kernel call this process made against its plain version, untimed
    (each rank held its own).  Returns the launches, the ranks' included."""
    t0 = time.perf_counter()
    ranks_launches = {}

    def phase(g):
        ranks_launches.update(pencil_phase(g))
        return ranks_launches

    with tune_env("off"), recorded_calls() as seen:
        launches = path_launches("distributed", phase, gen)
    print(f"phase 14: {time.perf_counter() - t0:.1f} s, {len(seen)} distinct kernel calls here", flush=True)
    own = {k: v - ranks_launches.get(k, 0) for k, v in launches.items()}
    path_kernel_rows("distributed", seen, own, gen, timed=False)
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 15: sharded training (repro_torch.sharding)
# ---------------------------------------------------------------------------

SHARD_WORLD = 4
#: Seconds: the four ranks' whole run (a hung rank is killed and fails the phase).
SHARD_TIMEOUT = 480
SHARD_TOL = 1e-4  # (b)–(d), float32: losses, aux relative; parameters relative to max|p|
SHARD_A_STEPS = 3
#: (b) h2o-danube-1.8b + use_spectral_mixer at full width, cut to 4 of 24
#: layers (two spectral/attn pairs): gloo's host wire moves each step's
#: FSDP gathers and reduce-scatters.  (layers, batch, seq, steps)
SHARD_B = (4, 4, 2048, 3)
#: (c) deepseek-moe-16b + use_spectral_mixer at full width, cut to 2 layers
#: (one spectral, one MoE), experts over ``model``.
SHARD_C = (2, 4, 1024, 2)


def shard_case(cfg, layers: int, batch: int, seq: int):
    """(cfg cut to ``layers`` at float32 compute, its TrainConfig, its
    DataConfig)."""
    from repro_torch.data.pipeline import DataConfig

    cfg = dataclasses.replace(cfg, num_layers=layers, compute_dtype="float32")
    tc = dataclasses.replace(train_config(), batch_size=batch, seq_len=seq)
    return cfg, tc, DataConfig(cfg.vocab_size, seq, batch)


def shard_batch(dcfg, i: int) -> dict:
    from repro_torch.data.pipeline import make_batch

    return {k: v.cuda() for k, v in make_batch(dcfg, i).items()}


def moe_dropped(model) -> list:
    return [int(layer.dropped) for layer in moe_layers(model)]


def shard_steps(state, cfg, tc, dcfg, first: int, count: int, label: str, ranked: bool,
                profile_last: bool = False) -> tuple:
    """``count`` steps from batch ``first``, each timed on the host clock
    (after a barrier where ``ranked``), its launches exactly
    :func:`step_expect`'s and (a sharded model) its collectives exactly
    ``shard.step_collectives``'; ``profile_last`` runs the last under the
    profiler (:func:`device_split`: the FFT kernels' and the other device
    ms, the busy share).  Returns (state, per-step records)."""
    from repro_torch.train.train_loop import make_train_step

    step = make_train_step(cfg, tc)
    expect = step_expect(state.model, dcfg.seq_len)
    sharded = shard.is_sharded(state.model)
    schedule = shard.step_collectives(state.model, dcfg.seq_len) if sharded else {}
    rows = []
    for i in range(first, first + count):
        batch = shard_batch(dcfg, i)
        before, comm = kernels.counts(), shard.counts()
        torch.cuda.synchronize()
        if ranked:
            dist.barrier()
        t0 = time.perf_counter()
        split, ran = None, {}
        if profile_last and i == first + count - 1:
            split = device_split(lambda: ran.update(out=step(state, batch)))
            state, met = ran["out"]
        else:
            state, met = step(state, batch)
        loss = float(met["loss"])
        torch.cuda.synchronize()
        if ranked:
            dist.barrier()
        ms = (time.perf_counter() - t0) * 1e3
        check_launches(f"{label} step {i}", before, kernels.counts(), expect)
        after = shard.counts()
        moved = {k: v - comm["counts"].get(k, 0) for k, v in after["counts"].items() if v != comm["counts"].get(k, 0)}
        nbytes = {k: v - comm["bytes"].get(k, 0) for k, v in after["bytes"].items() if v != comm["bytes"].get(k, 0)}
        check(moved == schedule, f"{label} step {i}: collectives {moved}, the schedule's {schedule}")
        rows.append({"step": i, "loss": loss, "aux": float(met["aux"]), "grad_norm": float(met["grad_norm"]),
                     "dropped": moe_dropped(state.model), "ms": ms, "collectives": moved, "bytes": nbytes})
        if split:
            rows[-1].update(profiled=True, fft_kernel_ms=split[0], other_device_ms=split[1],
                            fft_kernel_share=split[0] / ms, busy=(split[0] + split[1]) / ms, other_top=split[2])
    return state, rows


def sharded_world1(smi: str) -> dict:
    """Phase 15 (a): phase 10 (c)'s run (h2o-danube-1.8b + use_spectral_mixer
    at full width, B 2, S 4096, bf16, remat, AdamW, one repeated batch)
    through the sharded code path on one rank over NCCL: a 1×1
    ``DeviceMesh``, every parameter a ``DTensor``, each block a unit, 0
    collectives; its losses against phase 10 (c)'s at the bf16 gate."""
    from repro_torch.launch.mesh import make_mesh, parallel_config_for
    from repro_torch.train.train_loop import init_train_state, make_train_step

    from repro_torch.data.pipeline import DataConfig

    cfg, tc = serve_config(), train_config()
    dcfg = DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH)
    batch = shard_batch(dcfg, 0)
    if not TRAIN_RECORD:  # run alone (scripts/chip_phase.py 15): phase 10 (c)'s steps first
        state = init_train_state(cfg, tc, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))
        step = make_train_step(cfg, tc)
        losses = []
        for _ in range(SHARD_A_STEPS):
            state, met = step(state, batch)
            losses.append(float(met["loss"]))
        TRAIN_RECORD.update(losses=losses, step_ms=None)
        del state, step
        torch.cuda.empty_cache()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT))
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        torch.cuda.reset_peak_memory_stats()
        state = init_train_state(cfg, tc, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0),
                                 mesh=mesh, par=parallel_config_for(mesh))
        check(all(shard.layout(p) is not None for p in state.model.parameters()),
              "phase 15 (a): a parameter is not a DTensor")
        step = make_train_step(cfg, tc)
        expect = step_expect(state.model, TRAIN_SEQ)
        shard.reset_counts()
        losses, ms = [], []
        for i in range(SHARD_A_STEPS):
            before = kernels.counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, met = step(state, batch)
            losses.append(float(met["loss"]))
            ms.append((time.perf_counter() - t0) * 1e3)
            check_launches(f"phase 15 (a) step {i}", before, kernels.counts(), expect)
        check(not shard.counts()["counts"], f"phase 15 (a): collectives at world 1: {shard.counts()}")
        ref = TRAIN_RECORD["losses"][:SHARD_A_STEPS]
        errs = [abs(a - b) / abs(b) for a, b in zip(losses, ref)]
        check(max(errs) <= BF16_TOL, f"phase 15 (a): losses {losses} vs phase 10 (c)'s {ref}")
        rec = {"case": "a", "config": cfg.name + " use_spectral_mixer", "layers": cfg.num_layers, "mesh": "1x1",
               "backend": "nccl", "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "compute": cfg.compute_dtype,
               "losses": losses, "unsharded_losses": ref, "loss_rel_errs": errs, "step_ms": ms,
               "step_ms_after_first": statistics.mean(ms[1:]), "unsharded_step_ms": TRAIN_RECORD["step_ms"],
               "launches_per_step": expect, "collectives": {}, "peak_bytes": torch.cuda.max_memory_allocated(),
               "card": smi}
        del state, step
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return rec


def sharded_reference(cfg, tc, dcfg, steps: int, keep_params: bool) -> dict:
    """The one-device steps of a (b) or (c) case on the card from seed 0,
    float32: the records, and the final parameters on the host."""
    from repro_torch.train.train_loop import init_train_state

    state = init_train_state(cfg, tc, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))
    state, rows = shard_steps(state, cfg, tc, dcfg, 0, steps, f"phase 15 one device {cfg.name}", False)
    params = {n: p.detach().cpu() for n, p in state.model.named_parameters()} if keep_params else None
    del state
    torch.cuda.empty_cache()
    return {"rows": rows, "params": params}


def shard_errs(label: str, rows: list, ref: list, keys=("loss", "aux")) -> list:
    """Each step's metrics against the one-device run's at SHARD_TOL
    (relative; aux absolute where 0) and its dropped counts exactly."""
    errs = []
    for got, want in zip(rows, ref, strict=True):
        for k in keys:
            err = abs(got[k] - want[k]) / max(abs(want[k]), 1e-30) if want[k] else abs(got[k])
            check(err <= SHARD_TOL, f"{label} step {got['step']}: {k} {got[k]} vs one device {want[k]}")
            errs.append(err)
        check(got["dropped"] == want["dropped"], f"{label} step {got['step']}: dropped {got['dropped']} "
                                                 f"vs one device {want['dropped']}")
    return errs


def params_err(model, ref: dict) -> float:
    """max over parameters of max|local − ref's chunk| / max|ref|: each rank
    holds its own shards."""
    worst = 0.0
    for name, p in model.named_parameters():
        full = ref[name]
        lay = shard.layout(p)
        want = shard.local_chunk(full, lay[0], p.placements).cuda() if lay else full.cuda()
        worst = max(worst, ((shard.local(p.detach()) - want).abs().max() / full.abs().max().clamp(min=1e-30)).item())
    return worst


def sharded_rank_cases(rank: int, world: int, port: int, smi: str, ref_path: str) -> dict:
    """Phase 15 (b)–(d) on one rank: its cases against the one-device
    records, its launches, and each distinct kernel call it made against
    its plain version ("kernel_check ... sharded rank r" lines)."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch.mesh import make_mesh, parallel_config_for
    from repro_torch.train.train_loop import init_train_state

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT))
    try:
        gloo_cuda_probe("phase 15", rank, world, ("all_gather_into_tensor", "reduce_scatter_tensor", "all_reduce"))
        ref = torch.load(ref_path, mmap=True)
        gen = torch.Generator(device="cuda").manual_seed(15)
        m22, m41 = make_mesh((2, 2), ("data", "model")), make_mesh((4, 1), ("data", "model"))
        p22, p41 = parallel_config_for(m22, fsdp=True), parallel_config_for(m41, fsdp=True)
        records = []

        def fresh(cfg, tc, mesh, par):
            return init_train_state(cfg, tc, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0),
                                    mesh=mesh, par=par)

        with recorded_calls() as seen:
            kernels.reset_counts()
            shard.reset_counts()
            # (b) h2o-danube-1.8b + spectral, 4 layers, 2x2 with FSDP
            cfg, tc, dcfg = shard_case(serve_config(), *SHARD_B[:3])
            torch.cuda.reset_peak_memory_stats()
            state, rows = shard_steps(fresh(cfg, tc, m22, p22), cfg, tc, dcfg, 0, SHARD_B[3], "phase 15 (b)", True)
            errs = shard_errs(f"phase 15 (b) rank {rank}", rows, ref["b"]["rows"], ("loss",))
            perr = params_err(state.model, ref["b"]["params"])
            check(perr <= SHARD_TOL, f"phase 15 (b) rank {rank}: parameters off by {perr:.3e} of max|p|")
            records.append({"case": "b", "mesh": "2x2", "fsdp": True, "rows": rows, "loss_rel_errs": errs,
                            "param_rel_err": perr, "peak_bytes": torch.cuda.max_memory_allocated()})
            # (d) elastic: save at 2x2, restore at 4x1, one more step each way
            directory = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke", "sharded_ckpt")
            mgr = CheckpointManager(directory, keep=1)
            t0 = time.perf_counter()
            mgr.save(SHARD_B[3], state, extra={"data_step": SHARD_B[3]})
            save_s = time.perf_counter() - t0
            state, straight = shard_steps(state, cfg, tc, dcfg, SHARD_B[3], 1, "phase 15 (d) 2x2", True,
                                          profile_last=True)
            t0 = time.perf_counter()
            restored, extra = mgr.restore(SHARD_B[3], fresh(cfg, tc, m41, p41))
            restore_s = time.perf_counter() - t0
            check(restored.step == extra["data_step"] == SHARD_B[3], "phase 15 (d): the restored step")
            restored, resumed = shard_steps(restored, cfg, tc, dcfg, SHARD_B[3], 1, "phase 15 (d) 4x1", True)
            errs = shard_errs(f"phase 15 (d) rank {rank}", resumed, straight, ("loss",))
            worst = 0.0
            for (name, a), (_, b) in zip(restored.model.named_parameters(), state.model.named_parameters()):
                fa, fb = shard.full_tensor(a.detach()), shard.full_tensor(b.detach())
                worst = max(worst, ((fa - fb).abs().max() / fb.abs().max().clamp(min=1e-30)).item())
                del fa, fb
            check(worst <= SHARD_TOL, f"phase 15 (d) rank {rank}: parameters after the restored step off by {worst:.3e}")
            dist.barrier()
            if rank == 0:
                import shutil

                shutil.rmtree(directory, ignore_errors=True)
            records.append({"case": "d", "meshes": "2x2 -> 4x1", "fsdp": True, "straight": straight,
                            "resumed": resumed, "loss_rel_errs": errs, "param_rel_err": worst,
                            "save_s": save_s, "restore_s": restore_s})
            del state, restored
            torch.cuda.empty_cache()
            # (c) deepseek-moe-16b + spectral, 2 layers, 2x2 with FSDP, experts over model
            cfg, tc, dcfg = shard_case(moe_config(), *SHARD_C[:3])
            torch.cuda.reset_peak_memory_stats()
            # one more step than the one-device run's, under the profiler
            state, rows = shard_steps(fresh(cfg, tc, m22, p22), cfg, tc, dcfg, 0, SHARD_C[3] + 1, "phase 15 (c)",
                                      True, profile_last=True)
            errs = shard_errs(f"phase 15 (c) rank {rank}", rows[:-1], ref["c"]["rows"])
            records.append({"case": "c", "mesh": "2x2", "fsdp": True, "rows": rows, "rel_errs": errs,
                            "peak_bytes": torch.cuda.max_memory_allocated()})
            del state
            torch.cuda.empty_cache()
            launches = kernels.counts()
        path_kernel_rows(f"sharded rank {rank}", seen, launches, gen, timed=False)
        return {"records": records, "launches": launches}
    finally:
        dist.destroy_process_group()


def sharded_phase(gen) -> dict:
    """Phase 15: (a) one rank over NCCL in this process, then the one-device
    references of (b) and (c) here, then (b)–(d) on four ranks on this card
    over gloo; returns the ranks' kernel launches (this process counts its
    own)."""
    smi = card_line()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rec = sharded_world1(smi)
    print("sharded " + json.dumps(rec), flush=True)
    print(f"phase 15 (a): {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    ref = {"b": sharded_reference(*shard_case(serve_config(), *SHARD_B[:3]), SHARD_B[3], True),
           "c": sharded_reference(*shard_case(moe_config(), *SHARD_C[:3]), SHARD_C[3], False)}
    ref_path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke", "sharded_ref.pt")
    os.makedirs(os.path.dirname(ref_path), exist_ok=True)
    torch.save(ref, ref_path)
    print("sharded_reference " + json.dumps({k: v["rows"] for k, v in ref.items()}), flush=True)
    del ref
    print(f"phase 15 one-device references: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    try:
        ranks = spawn_ranks("phase 15", sharded_rank_cases, (smi, ref_path), SHARD_WORLD, SHARD_TIMEOUT)
    finally:
        os.remove(ref_path)
    launches = {}
    for r in sorted(ranks):
        for rec in ranks[r]["records"]:
            print("sharded " + json.dumps({"rank": r, "card": smi, **rec}), flush=True)
        print("sharded_rank " + json.dumps({"rank": r, "launches": ranks[r]["launches"]}), flush=True)
        for key, count in ranks[r]["launches"].items():
            launches[key] = launches.get(key, 0) + count
    same = [ranks[r]["launches"] == ranks[0]["launches"] for r in sorted(ranks)]
    check(all(same), f"phase 15: the ranks launched different kernels: {[ranks[r]['launches'] for r in ranks]}")
    print(f"phase 15 (b)-(d): {time.perf_counter() - t0:.1f} s (gloo: the host's wire, not NVLink)", flush=True)
    return launches


def sharded_path(gen) -> dict:
    """Phase 15 as one path: the counts at 0, :func:`sharded_phase`, every
    kernel of the path launched and no plain version; then each distinct
    kernel call this process made against its plain version, untimed.
    Returns the launches, the ranks' included."""
    t0 = time.perf_counter()
    ranks_launches = {}

    def phase(g):
        ranks_launches.update(sharded_phase(g))
        return ranks_launches

    with tune_env("off"), recorded_calls() as seen:
        launches = path_launches("sharded", phase, gen)
    print(f"phase 15: {time.perf_counter() - t0:.1f} s, {len(seen)} distinct kernel calls here", flush=True)
    own = {k: v - ranks_launches.get(k, 0) for k, v in launches.items()}
    path_kernel_rows("sharded", seen, own, gen, timed=False)
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 16: the dry run held against the card
# ---------------------------------------------------------------------------

DRY_PEAK_TOL = 0.10  # the traced peak vs the measured, relative to the measured
DRY_FLOPS_TOL = 0.01  # the traced dot flops vs the profiler's mm / bmm flops
DRY_RANK_TOL = 1e-4  # (d) four ranks, float32, vs one device, relative to max|ref|
DRY_WORLD1_STEPS = 16  # (d) greedy decode steps at world 1
DRY_RANK_STEPS = 8  # (d) decode steps on the four ranks
DRY_TIMEOUT = 300  # seconds, for (d)'s ranks and (e)'s cells
DRY_BUDGET_S = 150  # seconds: phase 16 as a whole
#: (d) four ranks: (label, config, layers, batch, prompt) at float32, 2×2,
#: the parameters replicated over ``data`` (each decode step gathers only
#: the weights a layer takes whole over ``model``).
DRY_RANK_CASES = (("h2o-danube-1.8b + spectral", "serve", 4, 4, 512),
                  ("deepseek-moe-16b + spectral", "moe", 2, 4, 256))
#: (e) production cells through ``run_cell``: (arch, shape, 2x16x16?).
DRY_CELLS = (("h2o-danube-1.8b", "train_4k", False), ("h2o-danube-1.8b", "decode_32k", False),
             ("arctic-480b", "train_4k", True), ("deepseek-moe-16b", "prefill_32k", False),
             ("fftbench", "pod_16m", False), ("gemma3-12b", "long_500k", False),
             ("zamba2-2.7b", "long_500k", True))
#: The ops whose flops ``torch.profiler`` (``with_flops``) and the trace's
#: ``dot_flops`` both count.
DOT_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")

#: The two CPU-only subprocesses of phase 16: (a)–(d)'s traces, in the
#: order they are read, and (e)'s cells; each prints one "dryrun_record"
#: line per record.
_TRACES = r"""
import json, sys, warnings
warnings.filterwarnings("ignore")
sys.path.insert(0, sys.argv[1])
import chip_smoke
for key, rec in chip_smoke.dry_traces():
    print("dryrun_record " + json.dumps([key, rec]), flush=True)
"""
_CELLS = r"""
import json, sys, warnings
warnings.filterwarnings("ignore")
from repro_torch.launch import dryrun
for arch, shape, multi in json.loads(sys.argv[2]):
    rec = dryrun.run_cell(arch, shape, multi, force=True)
    print("dryrun_record " + json.dumps([f"{arch} {shape} {multi}", rec]), flush=True)
"""


class Background:
    """A subprocess that needs no card (``CUDA_VISIBLE_DEVICES`` empty)
    tracing while the card works here: :meth:`get` waits for a record by
    key, :meth:`close` stops the process."""

    def __init__(self, code: str, *args: str):
        root = os.path.dirname(os.path.abspath(__file__))
        env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "PYTHONPATH": os.path.join(root, "src")}
        self.proc = subprocess.Popen([sys.executable, "-c", code, root, *args], env=env, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)
        self.lines: queue.Queue = queue.Queue()
        self.records, self.other = [], []
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            self.lines.put(line)
        self.lines.put(None)

    def get(self, key: str) -> dict:
        """The record ``key`` (failing the phase past DRY_TIMEOUT, or when
        the process ends without it)."""
        deadline = time.monotonic() + DRY_TIMEOUT
        while True:
            for k, rec in self.records:
                if k == key:
                    return rec
            try:
                line = self.lines.get(timeout=max(deadline - time.monotonic(), 0.1))
            except queue.Empty:
                raise SmokeFailure(f"phase 16: no record {key!r} within {DRY_TIMEOUT} s")
            check(line is not None, f"phase 16: the tracing process ended without {key!r}: "
                                    + "".join(self.other[-40:]))
            if line.startswith("dryrun_record "):
                self.records.append(tuple(json.loads(line.split(" ", 1)[1])))
            else:
                self.other.append(line)

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()


def traced(cfg, shape, mesh_shape=(1, 1), train_cfg=None, fsdp=None) -> dict:
    from repro_torch.launch import dryrun

    rec = dryrun.trace_cell(cfg, shape, mesh_shape, train_cfg, fsdp=fsdp)
    check(rec["status"] == "ok", f"phase 16: the trace of {shape.name} failed: {rec.get('error')}\n"
                                 f"{rec.get('traceback')}")
    return rec


def dry_traces():
    """Every trace (a)–(d) holds against the card, in the order they are
    read (run in :class:`Background`): phase 10 (c)'s step, with
    ``torch.utils.checkpoint``'s early stop on and off; phase 8's prefill
    and decode step; phase 14 (a)'s transforms at world 1; (d)'s cells on
    a fake group of 4."""
    from torch.utils.checkpoint import set_checkpoint_early_stop

    from repro_torch.configs import fftbench as fb
    from repro_torch.configs.base import ShapeConfig

    cfg = serve_config()
    train = ShapeConfig("phase 10 (c)", TRAIN_SEQ, TRAIN_BATCH, "train")
    yield "a", traced(cfg, train, train_cfg=train_config())
    with set_checkpoint_early_stop(False):
        yield "a early stop off", traced(cfg, train, train_cfg=train_config())
    yield "b prefill", traced(cfg, ShapeConfig("phase 8 prefill", SERVE_PROMPTS[0], 1, "prefill"))
    yield "b decode", traced(cfg, ShapeConfig("phase 8 decode", SERVE_MAX_LEN, SERVE_SLOTS, "decode"))
    shapes = {s.name: s for s in fb.FFT_SHAPES}
    for name in ("pod_16m", "sar_4kx8k"):
        yield name, traced(fb.CONFIG, shapes[name])
    for label, which, layers, batch, prompt in DRY_RANK_CASES:
        yield label, traced(dry_rank_config(which, layers),
                            ShapeConfig(label, prompt + DRY_RANK_STEPS, batch, "decode"), (2, 2), fsdp=False)


def own_bytes(*objs) -> int:
    """Bytes of the distinct storages of ``objs``' tensors on the card."""
    from repro_torch.analysis.trace import live_tensors

    seen = {}
    for t in live_tensors(*objs):
        if t.is_cuda:
            seen[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
    return sum(seen.values())


def measured_call(label: str, fn, args: tuple):
    """``fn()`` once after a synchronisation and a reset of the peak:
    (its result, ms on the host clock, the peak device bytes of the call
    with ``args`` — what the trace counts live from the start — and
    nothing else the process holds)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    other = torch.cuda.memory_allocated() - own_bytes(*args)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return out, ms, torch.cuda.max_memory_allocated() - other


def profiled_dot_flops(fn) -> float:
    """The mm / bmm flops of ``fn()`` by ``torch.profiler``'s ``with_flops``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU], with_flops=True) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.name in DOT_OPS and e.flops]
    print("dryrun_profiled " + json.dumps({"dot_ops": len(events)}), flush=True)
    return float(sum(e.flops for e in events))


def held_to_trace(label: str, rec: dict, launches: dict, ms: float, peak: int, flops=None, smi: str = "") -> dict:
    """A real call against its trace: launches equal, the peak within
    DRY_PEAK_TOL, the dot flops within DRY_FLOPS_TOL (where measured), the
    trace's lower bound at most the measured time."""
    pc = rec["per_chip"]
    traced_launches = {k: int(v) for k, v in rec["launches"].items()}
    check(launches == traced_launches, f"phase 16 {label}: launches {launches}, the trace's {traced_launches}")
    peak_err = abs(pc["peak_memory_bytes"] - peak) / peak
    check(peak_err <= DRY_PEAK_TOL, f"phase 16 {label}: traced peak {pc['peak_memory_bytes']} vs measured {peak}")
    row = {"case": label, "launches": launches, "ms": ms, "peak_bytes": peak,
           "traced_peak_bytes": pc["peak_memory_bytes"], "peak_rel_err": peak_err,
           "traced_dot_flops": pc["dot_flops"], "traced_bytes": pc["hbm_bytes"],
           "bound_ms": rec["roofline"]["step_lower_bound_s"] * 1e3, "bound_by": rec["roofline"]["bound"],
           "bound_over_measured": rec["roofline"]["step_lower_bound_s"] * 1e3 / ms, "eager_ops": pc["eager_ops"],
           "card": smi}
    check(row["bound_ms"] <= ms, f"phase 16 {label}: the trace's bound {row['bound_ms']:.2f} ms > measured {ms:.2f}")
    if flops is not None:
        err = abs(pc["dot_flops"] - flops) / flops
        check(err <= DRY_FLOPS_TOL, f"phase 16 {label}: traced dot flops {pc['dot_flops']} vs profiled {flops}")
        row.update(profiled_dot_flops=flops, dot_flops_rel_err=err)
    print("dryrun " + json.dumps(row), flush=True)
    return row


def delta(before: dict) -> dict:
    now = kernels.counts()
    return {k: v - before[k] for k, v in now.items() if v != before[k]}


def dry_train(traces: Background, smi: str) -> None:
    """(a): phase 10 (c)'s step traced on a fake 1×1 group, then two real
    steps of the one-device model: the first profiled (its mm / bmm flops),
    the second timed with its peak.  The profiled step and a second trace
    run with ``torch.utils.checkpoint``'s early stop off: with it on, the
    profiler records the product each block's recompute stops at (its
    saved input ends the recompute before the product runs), which no
    kernel computes and no trace sees."""
    from torch.utils.checkpoint import set_checkpoint_early_stop

    from repro_torch.data.pipeline import DataConfig
    from repro_torch.train.train_loop import init_train_state, make_train_step

    cfg, tc = serve_config(), train_config()
    state = init_train_state(cfg, tc, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))
    batch = shard_batch(DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH), 0)
    step = make_train_step(cfg, tc)
    ran = {}
    with set_checkpoint_early_stop(False):
        flops = profiled_dot_flops(lambda: ran.update(out=step(state, batch)))
    state = ran.pop("out")[0]
    before = kernels.counts()
    (state, met), ms, peak = measured_call("train", lambda: step(state, batch), (state, batch))
    check(math.isfinite(float(met["loss"])), "phase 16 (a): a non-finite loss")
    launches = delta(before)
    rec, full = traces.get("a"), traces.get("a early stop off")
    check(rec["launches"] == {k: float(v) for k, v in step_expect(state.model, TRAIN_SEQ).items()},
          f"phase 16 (a): traced launches {rec['launches']}, phase 10's {step_expect(state.model, TRAIN_SEQ)}")
    err = abs(full["per_chip"]["dot_flops"] - flops) / flops
    check(err <= DRY_FLOPS_TOL, f"phase 16 (a): traced dot flops {full['per_chip']['dot_flops']} (early stop "
                                f"off) vs profiled {flops}")
    row = held_to_trace("(a) train B 2 S 4096", rec, launches, ms, peak, smi=smi)
    print("dryrun " + json.dumps({"case": "(a) dot flops, checkpoint early stop off",
                                  "traced_dot_flops": full["per_chip"]["dot_flops"], "profiled_dot_flops": flops,
                                  "dot_flops_rel_err": err, "early_stop_saves": full["per_chip"]["dot_flops"]
                                  - row["traced_dot_flops"], "card": smi}), flush=True)
    del state, batch, step, ran
    torch.cuda.empty_cache()


def dry_serve(traces: Background, smi: str) -> None:
    """(b): phase 8's 4096-token prefill, a decode step at 4 slots of the
    bf16 model, and the step that flushes its spectral streams (the caches
    at phase C − 1), each traced at 1×1 and run once profiled, once timed;
    the flush step launches kernel #6 and #1 or #2."""
    cfg = serve_config()
    with torch.no_grad():
        model = DecoderLM(cfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))
        ids = torch.randint(0, cfg.vocab_size, (1, SERVE_PROMPTS[0]), device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(16))
        model.prefill(ids)  # plans and LUTs made once, as a served model's are
        flops = profiled_dot_flops(lambda: model.prefill(ids))
        before = kernels.counts()
        _, ms, peak = measured_call("prefill", lambda: model.prefill(ids), (model, ids))
        held_to_trace("(b) prefill 4096", traces.get("b prefill"), delta(before), ms, peak, flops, smi)
        caches = model.cache_init(SERVE_SLOTS, SERVE_MAX_LEN, dtype=torch.bfloat16)
        tok = ids[0, :SERVE_SLOTS].clone()
        t = SERVE_MAX_LEN - 1
        model.decode_step(tok, caches, t)
        flops = profiled_dot_flops(lambda: model.decode_step(tok, caches, t))
        before = kernels.counts()
        _, ms, peak = measured_call("decode", lambda: model.decode_step(tok, caches, t), (model, tok, caches))
        rec = traces.get("b decode")
        held_to_trace("(b) decode step 4 slots", rec, delta(before), ms, peak, flops, smi)
        c = model.stack[0].mixer.grain[0]
        check(rec.get("decode_cycle", {}).get("chunk") == c, f"phase 16 (b): the trace's cycle, C = {c}")
        flushing = [x._replace(phase=c - 1) if isinstance(x, SpectralStreamCache) else x for x in caches]
        model.decode_step(tok, flushing, t)
        flops = profiled_dot_flops(lambda: model.decode_step(tok, flushing, t))
        before = kernels.counts()
        _, ms, peak = measured_call("flush", lambda: model.decode_step(tok, flushing, t), (model, tok, flushing))
        row = held_to_trace("(b) flush step 4 slots", rec["flush_step"], delta(before), ms, peak, flops, smi)
        check({"rfft_recomb", "irfft_recomb"} < set(row["launches"]),
              f"phase 16 (b): the flush step launched {row['launches']}")
    del model, caches, flushing
    torch.cuda.empty_cache()


def dry_fft(traces: Background, gen, smi: str) -> None:
    """(c): phase 14 (a)'s ``pfft`` at 2^24 × 32 and ``pfft2d`` at 4096 ×
    8192 × 32, traced at world 1 and run on one rank: the artifact's plan
    is the plan that ran, the launches equal, the traced bytes over 3.35
    TB/s at most the measured ms."""
    from repro_torch.configs import fftbench as fb

    shapes = {s.name: s for s in fb.FFT_SHAPES}
    for name in ("pod_16m", "sar_4kx8k"):
        shape = shapes[name]
        rec = traces.get(name)
        info = rec["fft_plan"]
        if shape.kind == "fft1d":
            n, b = POD_16M
            pl = D.plan_pencil(n, 1)
            ran = {"leaf_lengths": [pl.n1, pl.n2], "a2a_count": pl.a2a_count(True),
                   "hbm_round_trips": max(p.fft_plan.hbm_round_trips for p in (pl.plan_n1, pl.plan_n2))}
            x = planes(gen, b, n)
            run = lambda: D.pfft(*x, n=n)  # noqa: E731
        else:
            n1, n2, b = SAR_SCENE
            ran = {"leaf_lengths": [n1, n2],
                   "hbm_round_trips": F.plan(F.FFTSpec(n=n2, kind="fft2", n2=n1)).fft_plan.hbm_round_trips}
            x = planes(gen, b, n1, n2)
            run = lambda: D.pfft2d(*x, n1=n1, n2=n2)  # noqa: E731
        check({k: info[k] for k in ran} == ran, f"phase 16 (c) {name}: the artifact's plan {info}, ran {ran}")
        run()
        ms = time_ms(run, reps=3, warmup=0)
        before = kernels.counts()
        run()
        torch.cuda.synchronize()
        launches = delta(before)
        traced_launches = {k: int(v) for k, v in rec["launches"].items()}
        check(launches == traced_launches, f"phase 16 (c) {name}: launches {launches}, traced {traced_launches}")
        bound = rec["per_chip"]["hbm_bytes"] / HBM_BYTES_PER_S * 1e3
        check(bound <= ms, f"phase 16 (c) {name}: traced bytes over HBM {bound:.2f} ms > measured {ms:.2f}")
        print("dryrun " + json.dumps({"case": f"(c) {name}", "fft_plan": ran, "launches": launches, "ms": ms,
                                      "traced_bytes": rec["per_chip"]["hbm_bytes"], "bytes_bound_ms": bound,
                                      "bound_over_measured": bound / ms, "card": smi}), flush=True)
        del x
        torch.cuda.empty_cache()


def serve_rows(model, ids, prompt: int, steps: int, greedy: bool) -> tuple:
    """A prefill of ``ids[:, :prompt]`` and ``steps`` decode steps (greedy,
    or fed ``ids`` after the prompt): (float32 logits per step (steps + 1,
    rows, vocab) on the host, the tokens fed, each decode step's
    collectives, each decode step's ms on the host clock)."""
    logits, caches = model.prefill(ids[:, :prompt])
    caches = model.prepare_decode_caches(caches, prompt + steps)
    rows, fed, colls, ms = [logits.float().cpu()], [], [], []
    for i in range(steps):
        tok = logits.argmax(-1) if greedy else ids[:, prompt + i]
        fed.append(tok.cpu())
        shard.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = model.decode_step(tok, caches, prompt + i)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        colls.append(shard.counts()["counts"])
        rows.append(logits.float().cpu())
    return torch.stack(rows), torch.stack(fed, 1), colls, ms


def dry_sharded_world1(smi: str) -> None:
    """(d) at world 1 over NCCL, full width, float32: phase 8's prompts
    through the model's prefill and 16 greedy steps, unsharded, then the
    same weights sharded on a 1×1 mesh: the same tokens, logits within
    phase 8's 1e-3·max|ref|, 0 collectives."""
    from repro_torch.launch.mesh import make_mesh, parallel_config_for

    cfg = dataclasses.replace(serve_config(), compute_dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(16)
    with torch.no_grad():
        model = DecoderLM(cfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))
        prompts = [torch.randint(0, cfg.vocab_size, (1, s), device="cuda", generator=gen) for s in SERVE_PROMPTS]
        want = [serve_rows(model, p, p.shape[1], DRY_WORLD1_STEPS, True) for p in prompts]
        dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", rank=0, world_size=1,
                                timeout=datetime.timedelta(seconds=GROUP_TIMEOUT))
        try:
            mesh = make_mesh((1, 1), ("data", "model"))
            shard.shard_model(model, mesh, parallel_config_for(mesh))
            for p, (ref, ref_tok, _, ref_ms) in zip(prompts, want):
                got, tok, colls, ms = serve_rows(model, p, p.shape[1], DRY_WORLD1_STEPS, True)
                err = ((got - ref).abs().max() / ref.abs().max()).item()
                check(torch.equal(tok, ref_tok), f"phase 16 (d) world 1 prompt {p.shape[1]}: tokens differ")
                check(err <= SERVE_TOL, f"phase 16 (d) world 1 prompt {p.shape[1]}: logits off by {err:.3e}")
                check(not any(colls), f"phase 16 (d) world 1: collectives {colls}")
                print("dryrun " + json.dumps({"case": "(d) world 1", "backend": "nccl", "prompt": p.shape[1],
                                              "steps": DRY_WORLD1_STEPS, "rel_err": err, "tokens_equal": True,
                                              "step_ms": statistics.median(ms[1:]),
                                              "unsharded_step_ms": statistics.median(ref_ms[1:]), "card": smi}),
                      flush=True)
        finally:
            dist.destroy_process_group()
    del model
    torch.cuda.empty_cache()


def dry_rank_config(which: str, layers: int):
    return dataclasses.replace(serve_config() if which == "serve" else moe_config(), num_layers=layers,
                               compute_dtype="float32")


def dry_rank_cases(rank: int, world: int, port: int, smi: str) -> dict:
    """(d) on one of four gloo ranks on the card: each case's one-device
    run here, then the same weights sharded 2×2, a prefill of this rank's
    rows and 8 decode steps against the one-device rows at 1e-4·max|ref|,
    every decode step's collectives = ``shard.decode_collectives``."""
    from repro_torch.launch.mesh import make_mesh, parallel_config_for

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT))
    try:
        gloo_cuda_probe("phase 16", rank, world, ("all_gather_into_tensor", "all_reduce"))
        mesh = make_mesh((2, 2), ("data", "model"))
        records = []
        with torch.no_grad():
            for label, which, layers, batch, prompt in DRY_RANK_CASES:
                cfg = dry_rank_config(which, layers)
                ids = torch.randint(0, cfg.vocab_size, (batch, prompt + DRY_RANK_STEPS), device="cuda",
                                    generator=torch.Generator(device="cuda").manual_seed(16))
                model = DecoderLM(cfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))
                ref, _, _, ref_ms = serve_rows(model, ids, prompt, DRY_RANK_STEPS, False)
                shard.shard_model(model, mesh, parallel_config_for(mesh))
                got, _, colls, ms = serve_rows(model, shard.data_rows(model, ids), prompt, DRY_RANK_STEPS, False)
                per = batch // mesh.size(0)
                mine = ref[:, mesh.get_local_rank(0) * per:(mesh.get_local_rank(0) + 1) * per]
                err = ((got - mine).abs().max() / ref.abs().max()).item()
                check(err <= DRY_RANK_TOL, f"phase 16 (d) {label} rank {rank}: logits off by {err:.3e}")
                schedule = shard.decode_collectives(model)
                check(all(c == schedule for c in colls),
                      f"phase 16 (d) {label} rank {rank}: collectives {colls}, the schedule's {schedule}")
                records.append({"case": label, "mesh": "2x2", "layers": layers, "batch": batch, "prompt": prompt,
                                "steps": DRY_RANK_STEPS, "rel_err": err, "collectives": schedule,
                                "step_ms": statistics.median(ms[1:]), "one_device_step_ms": statistics.median(ref_ms[1:])})
                del model
                torch.cuda.empty_cache()
        return {"records": records, "launches": kernels.counts()}
    finally:
        dist.destroy_process_group()


def dry_sharded_ranks(background: Background, smi: str) -> dict:
    """(d) on four gloo ranks, each case's decode collectives also held to
    the dry run's trace of the same cell on a fake group of 4; returns the
    ranks' launches."""
    ranks = spawn_ranks("phase 16", dry_rank_cases, (smi,), 4, DRY_TIMEOUT)
    traces = {}
    for label, *_ in DRY_RANK_CASES:
        counts = background.get(label)["per_chip"]["collective_count_by_type"]
        traces[label] = {k: int(v) for k, v in counts.items()}
    launches = {}
    for r in sorted(ranks):
        for rec in ranks[r]["records"]:
            check(rec["collectives"] == traces[rec["case"]],
                  f"phase 16 (d) {rec['case']}: collectives {rec['collectives']}, traced {traces[rec['case']]}")
            print("dryrun " + json.dumps({"rank": r, "backend": "gloo", "traced_collectives": traces[rec["case"]],
                                          "card": smi, **rec}), flush=True)
        for key, count in ranks[r]["launches"].items():
            launches[key] = launches.get(key, 0) + count
    return launches


def dry_cells(cells: Background) -> None:
    """(e): every production cell's record line; each ``ok``, the two
    ``long_500k`` cells (one sequence, replicated over ``data``) too."""
    for arch, shape, multi in DRY_CELLS:
        rec = dict(cells.get(f"{arch} {shape} {multi}"))
        rec.pop("traceback", None)
        print("dryrun_cell " + json.dumps(rec), flush=True)
        check((rec["arch"], rec["shape"], rec["mesh"]) == (arch, shape, "2x16x16" if multi else "16x16"),
              f"phase 16 (e): the record of {rec['arch']} {rec['shape']} {rec['mesh']} out of order")
        check(rec["status"] == "ok",
              f"phase 16 (e) {rec['arch']} {rec['shape']} {rec['mesh']}: {rec.get('error')}")


def dryrun_phase(gen) -> dict:
    """Phase 16: the traces of (a)–(d) and (e)'s cells start in two CPU-only
    subprocesses, then (a)–(d) run here; returns (d)'s ranks' launches."""
    smi = card_line()
    traces, cells = Background(_TRACES), Background(_CELLS, json.dumps(DRY_CELLS))
    try:
        for label, run in (("(a)", lambda: dry_train(traces, smi)), ("(b)", lambda: dry_serve(traces, smi)),
                           ("(c)", lambda: dry_fft(traces, gen, smi)),
                           ("(d) world 1", lambda: dry_sharded_world1(smi))):
            t0 = time.perf_counter()
            run()
            print(f"phase 16 {label}: {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        ranks = dry_sharded_ranks(traces, smi)
        print(f"phase 16 (d) four ranks: {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        dry_cells(cells)
        print(f"phase 16 (e): waited {time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        traces.close()
        cells.close()
    return ranks


def dryrun_path(gen) -> dict:
    """Phase 16 as one path: the counts at 0, :func:`dryrun_phase`, every
    kernel of the path launched and no plain version; then each distinct
    kernel call this process made against its plain version, untimed (the
    traces launch nothing: their fake tensors stay on the host)."""
    t0 = time.perf_counter()
    ranks_launches = {}

    def phase(g):
        ranks_launches.update(dryrun_phase(g))
        return ranks_launches

    with tune_env("off"), recorded_calls() as seen:
        launches = path_launches("dryrun", phase, gen)
    took = time.perf_counter() - t0
    print(f"phase 16: {took:.1f} s, {len(seen)} distinct kernel calls here", flush=True)
    check(took <= DRY_BUDGET_S, f"phase 16 took {took:.1f} s, past its {DRY_BUDGET_S} s")
    own = {k: v - ranks_launches.get(k, 0) for k, v in launches.items()}
    path_kernel_rows("dryrun", seen, own, gen, timed=False)
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 17: the reference's decode sharding (weight-stationary FSDP decode,
# the sequence-sharded KV cache)
# ---------------------------------------------------------------------------

LONG_LEN = 524288  # long_500k's positions
LONG_STEPS = 8  # (a) greedy steps at t = LONG_LEN − 8 … LONG_LEN − 1
LONG_LAYERS = 6  # (a) one 5:1 local/global period of gemma3-12b
LONG_TOL = 1e-4  # (a)–(c) vs one device, relative to max|ref|
#: (b)'s layer: compute dtype, cache dtype, KV kind, tolerance relative to
#: max|ref|.  A bf16 step rounds its output to bf16, whose ulp is 2^-8 of
#: it: any other order of the 524288-slot sums moves an element by one ulp
#: on either side (2^-7); float32 and int8 (exact products) hold 1e-4.
LONG_ATTN = {"float32": (torch.float32, torch.float32, "bf16", LONG_TOL),
             "bf16": (torch.bfloat16, torch.bfloat16, "bf16", 2.0**-7),
             "int8": (torch.bfloat16, torch.bfloat16, "int8", LONG_TOL)}
LONG_FILL_CHUNK = 65536  # slots of one seeded draw of a filled cache
LONG_FLUSH = (512, 260)  # (c) prompt, decode steps (one stream flush at C = 256)
LONG_TIMEOUT = 300  # seconds, for the ranks and the traces
LONG_BUDGET_S = 120  # seconds: phase 17 as a whole

#: The CPU-only subprocess of phase 17: the traces of (a) and (c) on a fake
#: group of 4, one "dryrun_record" line each.
_LONG_TRACES = r"""
import json, sys, warnings
warnings.filterwarnings("ignore")
sys.path.insert(0, sys.argv[1])
import chip_smoke
for key, rec in chip_smoke.long_traces():
    print("dryrun_record " + json.dumps([key, rec]), flush=True)
"""


def long_config():
    """gemma3-12b at full width (d_model 3840, 16 heads, 8 kv of 256,
    vocab 262144), one 5:1 local/global period, float32."""
    return dataclasses.replace(get_config("gemma3-12b"), num_layers=LONG_LAYERS, compute_dtype="float32")


def long_traces():
    """(a)'s step and (c)'s cell traced at 2×2 on a fake group of 4 (run in
    :class:`Background`)."""
    from repro_torch.configs.base import ShapeConfig

    yield "a", traced(long_config(), ShapeConfig("phase 17 (a)", LONG_LEN, 1, "decode"), (2, 2), fsdp=True)
    yield "c", traced(dry_rank_config("serve", 4), ShapeConfig("phase 17 (c)", sum(LONG_FLUSH), 1, "decode"),
                      (2, 2), fsdp=False)


def long_fill(caches, slots_of, seed: int, kv_total: int, kv_range=None) -> None:
    """Fill each KV cache in ``caches`` (a rank's shard, or the whole) with
    the seeded contents of the global cache: field f of layer l, slots c·N …
    (c + 1)·N − 1 (N = LONG_FILL_CHUNK) drawn over the row and all
    ``kv_total`` kv heads from a generator seeded by (seed, l, f, c) —
    normal values, or int8 ones and their scales — then cut to the shard's
    slots (a SeqKVCache's ``start`` on) and kv heads (``kv_range(l)``:
    (first, count); all of them by default).  ``slots_of(l)``: the layer's
    global slot count."""
    from repro_torch.models.layers.attention import SeqKVCache

    for layer, cache in enumerate(caches):
        total = slots_of(layer)
        s0, n = (cache.start if isinstance(cache, SeqKVCache) else 0), cache.k.shape[1]
        k0, nk = kv_range(layer) if kv_range else (0, kv_total)
        for f, buf in enumerate(t for t in cache[:4] if t is not None):
            for c0 in range(0, total, LONG_FILL_CHUNK):
                lo, hi = max(c0, s0), min(c0 + LONG_FILL_CHUNK, s0 + n, total)
                if lo >= hi:
                    continue
                g = torch.Generator(device="cuda").manual_seed(((seed * 64 + layer) * 8 + f) * 4096 + c0 // LONG_FILL_CHUNK)
                shape = (buf.shape[0], min(LONG_FILL_CHUNK, total - c0), kv_total) + tuple(buf.shape[3:])
                if buf.dtype == torch.int8:
                    draw = torch.randint(-127, 128, shape, generator=g, device="cuda", dtype=torch.int8)
                elif buf.dim() == 3:  # the int8 scales
                    draw = 0.004 + 0.026 * torch.rand(shape, generator=g, device="cuda")
                else:
                    draw = torch.randn(shape, generator=g, device="cuda").to(buf.dtype)
                buf[:, lo - s0:hi - s0] = draw[:, lo - c0:hi - c0].narrow(2, k0, nk)


def long_slots(cfg):
    """Layer → its cache's global slot count (a window layer's ring)."""
    pattern = cfg.pattern()
    return lambda layer: min(cfg.sliding_window, LONG_LEN) if pattern[layer] == "attn_local" else LONG_LEN


def long_attention(kind: str):
    """(b)'s layer: gemma3-12b's global attention (16 heads, 8 kv of 256)
    from a seed, computing in ``LONG_ATTN[kind]``'s dtype over its cache,
    its input token, and the cache's dtype."""
    from repro_torch.models.layers.attention import Attention

    compute, cache_dtype, kv_kind, _ = LONG_ATTN[kind]
    cfg = dataclasses.replace(long_config(), compute_dtype=str(compute).replace("torch.", ""), kv_cache_dtype=kv_kind)
    attn = Attention(cfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(20))
    x = torch.randn(1, 1, cfg.d_model, device="cuda", generator=torch.Generator(device="cuda").manual_seed(18))
    return attn, x.to(compute), cache_dtype


def long_one_device(smi: str) -> dict:
    """The one-device references of (a)–(c) on the card: (a) 8 greedy steps
    of the 6-layer gemma3-12b (float32) over filled 524288-position caches;
    (b) one step of (b)'s layer over a filled 524288-slot cache, bf16 and
    int8; (c) h2o + spectral at batch 1 (float32), a 512 prompt and 260
    teacher-forced steps."""
    cfg = long_config()
    out = {}
    with torch.no_grad():
        model = DecoderLM(cfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))
        caches = model.cache_init(1, LONG_LEN)
        long_fill(caches, long_slots(cfg), 0, cfg.num_kv_heads)
        torch.cuda.reset_peak_memory_stats()  # the steps' peak, as the ranks measure theirs
        tok = torch.randint(0, cfg.vocab_size, (1,), device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(17))
        rows, fed, ms = [], [], []
        for i in range(LONG_STEPS):
            fed.append(tok.clone())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, caches = model.decode_step(tok, caches, LONG_LEN - LONG_STEPS + i)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            rows.append(logits.float().cpu())
            tok = logits.argmax(-1)
        out["a"] = {"logits": torch.stack(rows), "tokens": torch.stack(fed).cpu(), "ms": statistics.median(ms[1:]),
                    "peak_bytes": torch.cuda.max_memory_allocated()}
        del model, caches
        torch.cuda.empty_cache()
        out["b"] = {}
        for kind in LONG_ATTN:
            attn, x, cache_dtype = long_attention(kind)
            cache = attn.cache_init(1, LONG_LEN, cache_dtype, "cuda")
            long_fill([cache], lambda _: LONG_LEN, 1, attn.cfg.num_kv_heads)
            y, cache = attn.decode(x, cache, LONG_LEN - 1)
            out["b"][kind] = {"y": y.float().cpu(), "slot": [t[:, LONG_LEN - 1].cpu() for t in cache[:4] if t is not None]}
            del attn, cache
            torch.cuda.empty_cache()
        ccfg = dry_rank_config("serve", 4)
        prompt, steps = LONG_FLUSH
        ids = torch.randint(0, ccfg.vocab_size, (1, prompt + steps), device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(19))
        model = DecoderLM(ccfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))
        ref, _, _, ref_ms = serve_rows(model, ids, prompt, steps, False)
        out["c"] = {"logits": ref, "ids": ids.cpu(), "ms": statistics.median(ref_ms[1:])}
        del model
        torch.cuda.empty_cache()
    print("long_reference " + json.dumps({"a_step_ms": out["a"]["ms"], "a_peak_bytes": out["a"]["peak_bytes"],
                                          "c_step_ms": out["c"]["ms"], "tokens": out["a"]["tokens"].flatten().tolist(),
                                          "card": smi}), flush=True)
    return out


def long_rank_cases(rank: int, world: int, port: int, smi: str, ref_path: str) -> dict:
    """(a)–(c) on one of four gloo ranks on the card, against the one-device
    references at ``ref_path``."""
    from repro_torch.launch.mesh import make_mesh, parallel_config_for
    from repro_torch.models.layers.attention import SeqKVCache
    from repro_torch.sharding.logical import mesh_context

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    ref = torch.load(ref_path)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT))
    out = {}
    try:
        gloo_cuda_probe("phase 17", rank, world, ("all_gather_into_tensor", "all_reduce"))
        mesh = make_mesh((2, 2), ("data", "model"))
        cfg = long_config()
        with torch.no_grad():
            # (a) weight-stationary FSDP decode at full width over 524288 slots.
            par = dataclasses.replace(parallel_config_for(mesh, fsdp=True), decode_weight_stationary=True)
            model = DecoderLM(cfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))
            shard.shard_model(model, mesh, par)
            torch.cuda.empty_cache()
            caches = model.cache_init(1, LONG_LEN)
            with shard.context(model):
                kv_of = {layer: block.mixer.kv_local() for layer, block in enumerate(model.stack)}
            long_fill(caches, long_slots(cfg), 0, cfg.num_kv_heads, kv_of.__getitem__)
            torch.cuda.reset_peak_memory_stats()  # the steps' peak: the shards, the caches, the step
            want = ref["a"]["logits"]
            rows, colls, by_axis, ms, schedule = [], [], [], [], []
            for i in range(LONG_STEPS):
                tok = ref["a"]["tokens"][i].cuda()
                shard.reset_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, caches = model.decode_step(tok, caches, LONG_LEN - LONG_STEPS + i)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                c = shard.counts()
                colls.append(c["counts"])
                by_axis.append(c["by_axis"])
                schedule.append(shard.decode_collectives(model, caches, 1))
                rows.append(logits.float().cpu())
            got = torch.stack(rows)
            err = ((got - want).abs().max() / want.abs().max()).item()
            check(err <= LONG_TOL, f"phase 17 (a) rank {rank}: logits off by {err:.3e}")
            check(torch.equal(got[:-1].argmax(-1), ref["a"]["tokens"][1:].cpu()), f"phase 17 (a) rank {rank}: greedy tokens differ")
            check(all(c == s for c, s in zip(colls, schedule)), f"phase 17 (a) rank {rank}: collectives {colls[-1]}, the schedule's {schedule[-1]}")
            gathered = sorted({k for b in by_axis for k in b if k.startswith("all_gather:data")})
            check(not gathered, f"phase 17 (a) rank {rank}: gathers over data {gathered}")
            out["a"] = {"rel_err": err, "collectives": colls[-1], "by_axis": by_axis[-1],
                        "step_ms": statistics.median(ms[1:]), "peak_bytes": torch.cuda.max_memory_allocated()}
            del model, caches
            torch.cuda.empty_cache()

            # (b) the sequence-sharded attention at gemma3's global-layer
            # shapes: the slots over the four ranks (a 4×1 mesh: the layer
            # whole on each rank, the reductions over data).
            mesh41 = make_mesh((4, 1), ("data", "model"))
            n = LONG_LEN // world
            out["b"] = {}
            for kind, (_, _, _, tol) in LONG_ATTN.items():
                attn, x, cache_dtype = long_attention(kind)
                cache = SeqKVCache(*attn.cache_init(1, n, cache_dtype, "cuda"), start=rank * n,
                                   axes=("data", "model"))
                long_fill([cache], lambda _: LONG_LEN, 1, attn.cfg.num_kv_heads)
                before = [t.clone() for t in cache[:4] if t is not None]
                shard.reset_counts()
                with mesh_context(mesh41, parallel_config_for(mesh41)):
                    y, cache = attn.decode(x, cache, LONG_LEN - 1)
                colls_b = shard.counts()["counts"]
                want_y = ref["b"][kind]["y"]
                err = ((y.float().cpu() - want_y).abs().max() / want_y.abs().max()).item()
                check(err <= tol, f"phase 17 (b) {kind} rank {rank}: output off by {err:.3e} (≤ {tol:.1e})")
                now = [t for t in cache[:4] if t is not None]
                changed = int(sum(int((a != b).reshape(a.shape[0], a.shape[1], -1).any(-1).sum())
                                  for a, b in zip(now, before)))
                owner = (LONG_LEN - 1) // n == rank
                if owner:
                    for t, w in zip(now, ref["b"][kind]["slot"]):
                        check(torch.equal(t[:, n - 1].cpu(), w), f"phase 17 (b) {kind} rank {rank}: the written slot differs")
                out["b"][kind] = {"rel_err": err, "changed": changed, "owner": owner, "collectives": colls_b}
                del attn, cache, before, now
                torch.cuda.empty_cache()

            # (c) h2o + spectral at batch 1 (replicated over data), one flush.
            ccfg = dry_rank_config("serve", 4)
            prompt, steps = LONG_FLUSH
            ids = ref["c"]["ids"].cuda()
            model = DecoderLM(ccfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))
            shard.shard_model(model, mesh, parallel_config_for(mesh))
            logits, caches = model.prefill(shard.data_rows(model, ids)[:, :prompt])
            caches = model.prepare_decode_caches(caches, prompt + steps)
            rows, ms, colls = [logits.float().cpu()], [], []
            launched = kernels.counts()
            for i in range(steps):
                shard.reset_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, caches = model.decode_step(ids[:, prompt + i], caches, prompt + i)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                colls.append(shard.counts()["counts"])
                rows.append(logits.float().cpu())
            after = kernels.counts()
            launched = {k: v - launched.get(k, 0) for k, v in after.items() if v != launched.get(k, 0)}
            got, want = torch.stack(rows), ref["c"]["logits"]
            err = ((got - want).abs().max() / want.abs().max()).item()
            check(err <= LONG_TOL, f"phase 17 (c) rank {rank}: logits off by {err:.3e}")
            schedule = shard.decode_collectives(model, caches, 1)
            check(all(c == schedule for c in colls), f"phase 17 (c) rank {rank}: collectives {colls[-1]}, the schedule's {schedule}")
            out["c"] = {"rel_err": err, "collectives": schedule, "decode_launches": launched,
                        "step_ms": statistics.median(ms[1:])}
            del model, caches
            torch.cuda.empty_cache()
        return {"records": out, "launches": kernels.counts()}
    finally:
        dist.destroy_process_group()


def long_phase(gen) -> dict:
    """Phase 17: the traces of (a) and (c) start in a CPU-only subprocess,
    the one-device references run here, then (a)–(c) on four gloo ranks on
    this card; returns the ranks' kernel launches."""
    smi = card_line()
    traces = Background(_LONG_TRACES)
    ref_path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke", "long_ref.pt")
    try:
        t0 = time.perf_counter()
        torch.save(long_one_device(smi), ref_path)
        print(f"phase 17 one-device references: {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        try:
            ranks = spawn_ranks("phase 17", long_rank_cases, (smi, ref_path), 4, LONG_TIMEOUT)
        finally:
            os.remove(ref_path)
        print(f"phase 17 (a)-(c) four ranks: {time.perf_counter() - t0:.1f} s (gloo: the host's wire, not NVLink)",
              flush=True)
        rec_a, rec_c = traces.get("a"), traces.get("c")
    finally:
        traces.close()
    traced_a = {k: int(v) for k, v in rec_a["per_chip"]["collective_count_by_type"].items()}
    flush = {k: int(v) for k, v in rec_c["flush_step"]["launches"].items()}
    launches = {}
    for r in sorted(ranks):
        rec = ranks[r]["records"]
        check(rec["a"]["collectives"] == traced_a,
              f"phase 17 (a) rank {r}: collectives {rec['a']['collectives']}, traced {traced_a}")
        traced_axes = rec_a["per_chip"]["collectives_by_axis"]
        check(rec["a"]["by_axis"] == traced_axes, f"phase 17 (a) rank {r}: by axis {rec['a']['by_axis']}, traced {traced_axes}")
        check(rec["c"]["decode_launches"] == flush and rec_c["launches"] == {},
              f"phase 17 (c) rank {r}: decode launches {rec['c']['decode_launches']}, the trace's flush {flush}")
        print("long " + json.dumps({"rank": r, "backend": "gloo", "card": smi, "traced_a": traced_a,
                                    "traced_a_peak_bytes": rec_a["per_chip"]["peak_memory_bytes"], **rec}),
              flush=True)
        for key, count in ranks[r]["launches"].items():
            launches[key] = launches.get(key, 0) + count
    for kind in LONG_ATTN:
        owners = [r for r in ranks if ranks[r]["records"]["b"][kind]["owner"]]
        changed = [r for r in ranks if ranks[r]["records"]["b"][kind]["changed"]]
        check(owners == changed and len(changed) == 1,
              f"phase 17 (b) {kind}: the written slot landed on ranks {changed}, owner {owners}")
    return launches


def long_path(gen) -> dict:
    """Phase 17 as one path: the counts at 0, :func:`long_phase`, every
    kernel of the path launched ((c)'s flush) and no plain version; then
    each distinct kernel call this process made against its plain
    version."""
    t0 = time.perf_counter()
    ranks_launches = {}

    def phase(g):
        ranks_launches.update(long_phase(g))
        return ranks_launches

    with tune_env("off"), recorded_calls() as seen:
        launches = path_launches("long", phase, gen)
    took = time.perf_counter() - t0
    print(f"phase 17: {time.perf_counter() - t0:.1f} s, {len(seen)} distinct kernel calls here", flush=True)
    check(took <= LONG_BUDGET_S, f"phase 17 took {took:.1f} s, past its {LONG_BUDGET_S} s")
    own = {k: v - ranks_launches.get(k, 0) for k, v in launches.items()}
    path_kernel_rows("long", seen, own, gen, timed=False)
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs the card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full fp32
    torch.backends.cudnn.allow_tf32 = False
    smi = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind} | nvidia-smi: {smi} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    info = build.build()  # every csrc/*.cu, one nvcc each, in parallel
    build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s (compiled={info['compiled']}) {info['path']}", flush=True)
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "Function properties" in line:
            print("ptxas: " + line.strip(), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    # A throwaway tuning cache inside the checkout's build directory.
    cache_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke")
    os.makedirs(cache_dir, exist_ok=True)
    os.environ["REPRO_TUNING_CACHE"] = os.path.join(cache_dir, "tuning.json")
    tuning.cache.clear()
    try:
        ATTRS.update(build.kernel_attributes())
        register_guard()
        with tune_env("off"):  # phases 2–8 hold the heuristic plans
            rows = kernel_phase(gen)
            main = path_launches("main_path", main_path_phase, gen)
            offsets_phase(gen)
            real2d = path_launches("real2d", lambda g: calls_phase(g, REAL_2D, "real2d"), gen)
            any_length = path_launches(
                "bluestein", lambda g: calls_phase(g, ANY_LENGTH, "any_length"), gen)
            with recorded_calls() as seen:
                convs = path_launches("conv", conv_phase, gen)
            path_kernel_rows("conv", seen, convs, gen)
            with recorded_calls() as seen, torch.no_grad():
                served = path_launches("serve", serve_phase, gen)
            path_kernel_rows("serve", seen, served, gen)
        t9 = time.perf_counter()
        with recorded_calls() as seen:
            tuned = path_launches("tune", tune_phase, gen)
        print(f"phase 9: {time.perf_counter() - t9:.1f} s, {len(seen)} distinct kernel calls", flush=True)
        path_kernel_rows("tune", seen, tuned, gen, timed=False)
        t10 = time.perf_counter()
        with tune_env("off"), recorded_calls() as seen:
            trained = path_launches("train", grad_phase, gen)
        print(f"phase 10: {time.perf_counter() - t10:.1f} s, {len(seen)} distinct kernel calls", flush=True)
        path_kernel_rows("train", seen, trained, gen)
        torch.cuda.empty_cache()
        t11 = time.perf_counter()
        with tune_env("off"), recorded_calls() as seen, torch.no_grad():
            moe = path_launches("moe", moe_phase, gen)
        print(f"phase 11: {time.perf_counter() - t11:.1f} s, {len(seen)} distinct kernel calls", flush=True)
        path_kernel_rows("moe", seen, moe, gen)
        torch.cuda.empty_cache()
        t12 = time.perf_counter()
        with tune_env("off"), torch.no_grad():
            hybrid = path_launches("hybrid", recurrent_phase, gen)
        print(f"phase 12: {time.perf_counter() - t12:.1f} s", flush=True)
        t13 = time.perf_counter()
        with tune_env("off"), recorded_calls() as seen, torch.no_grad():
            frontend = path_launches("frontend", frontend_phase, gen)
        print(f"phase 13: {time.perf_counter() - t13:.1f} s, {len(seen)} distinct kernel calls", flush=True)
        path_kernel_rows("frontend", seen, frontend, gen)
        torch.cuda.empty_cache()
        distributed = distributed_path(gen)
        sharded = sharded_path(gen)
        dryrun = dryrun_path(gen)
        long = long_path(gen)
        launches = {name: main[name] + real2d[name] + any_length[name] + convs[name] + served[name]
                    + tuned[name] + trained[name] + moe[name] + hybrid[name] + frontend[name]
                    + distributed[name] + sharded[name] + dryrun[name] + long[name] for name in SOURCES}
    except SmokeFailure as err:
        print(f"chip_smoke: FAILED: {err}", file=sys.stderr)
        return 1

    out = []
    for name, (source, replaces) in SOURCES.items():
        r = rows[name]
        out.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "train_launches": trained[name], "moe_launches": moe[name],
            "hybrid_launches": hybrid[name], "frontend_launches": frontend[name],
            "distributed_launches": distributed[name], "sharded_launches": sharded[name],
            "dryrun_launches": dryrun[name], "long_launches": long[name],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": r["shape"],
            **{k: r[k] for k in ("library_without_twiddle_ms",) if k in r},
            "registers": r["registers"], "local_bytes": r["local_bytes"],
        })
    print(json.dumps({"kernels": out}), flush=True)
    print(smi, flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
