"""The yardstick's arithmetic: the card's peaks, and what each piece of work
needs (bytes and operations), counted from the inputs and the configuration
whatever the program pads to or computes.

Copied from ``chip_smoke.py`` (``bound_ms``: bytes read once and written
once over 3.35 TB/s, 5·n·log2 n flops a complex transform over 67 TFLOP/s)
and ``repro_torch.analysis.roofline.model_flops`` (2·N·D a token forward);
neither is imported.
"""

from __future__ import annotations

import math

from portbench.reference.danube import layer_kinds

#: Published peaks of one H100 SXM (NVIDIA data sheet, dense, at 700 W).
PEAKS = {
    "hbm_bytes_per_s": 3.35e12,
    "fp32_flops_per_s": 67e12,
    "bf16_flops_per_s": 989e12,
}


def least_s(nbytes: float, flops: float, flops_per_s: float = PEAKS["fp32_flops_per_s"]) -> float:
    """The least time the chip could take: the larger of bytes over HBM
    bandwidth and operations over the peak rate."""
    return max(nbytes / PEAKS["hbm_bytes_per_s"], flops / flops_per_s)


def fft_flops(n: int, real: bool = False) -> float:
    """5·n·log2 n for a complex transform of n points, half that for a real one."""
    f = 5.0 * n * math.log2(n) if n > 1 else 0.0
    return f / 2 if real else f


def stripmap_need(n_az: int, n_rg: int, chirp_len: int) -> dict:
    """One stripmap block: the complex64 raw block read once and the float32
    image written once; per echo line a complex FFT at the linear-correlation
    length (n_rg + chirp_len − 1), its inverse and the spectrum product
    (6 flops a bin), and a complex n_az-point azimuth FFT per column.  The
    replica's spectrum is counted once a run (:func:`filter_flops`)."""
    n_lin = n_rg + chirp_len - 1
    range_flops = n_az * (2 * fft_flops(n_lin) + 6.0 * n_lin)
    azimuth_flops = n_rg * fft_flops(n_az)
    nbytes = (8.0 + 4.0) * n_az * n_rg
    return {"bytes": nbytes, "flops": range_flops + azimuth_flops,
            "least_s": least_s(nbytes, range_flops + azimuth_flops)}


def filter_flops(n_rg: int, chirp_len: int) -> float:
    """The replica's spectrum: one complex FFT at the linear-correlation length."""
    return fft_flops(n_rg + chirp_len - 1)


def spotlight_need(n_az: int, n_rg: int) -> dict:
    """One spotlight scene: the complex64 phase history read once and the
    float32 magnitude written once; a complex 2-D FFT (n_az rows of n_rg
    points, n_rg columns of n_az points)."""
    nbytes = 8.0 * n_az * n_rg + 4.0 * n_az * n_rg
    flops = n_az * fft_flops(n_rg) + n_rg * fft_flops(n_az)
    return {"bytes": nbytes, "flops": flops, "least_s": least_s(nbytes, flops)}


def batched_fft_need(n: int, batch: int) -> dict:
    """One batch of complex64 1-D FFTs: read once and written once."""
    nbytes = 2 * 8.0 * n * batch
    flops = batch * fft_flops(n)
    return {"bytes": nbytes, "flops": flops, "least_s": least_s(nbytes, flops)}


def lm_matrix_params(cfg: dict) -> int:
    """The parameters of the matrix products outside the embedding table
    and the head (norm scales and the spectral filters' taps are not
    matrices; the filters' convolution is counted by its transforms)."""
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    hd = d // cfg["num_attention_heads"]
    attn = d * cfg["num_attention_heads"] * hd * 2 + d * cfg["num_key_value_heads"] * hd * 2
    spectral = 3 * d * d
    mlp = 3 * d * f
    total = 0
    for kind in layer_kinds(cfg):
        total += (attn if kind == "attn" else spectral) + mlp
    return total


def prefill_flops(cfg: dict, s: int) -> float:
    """The flops one prompt of ``s`` tokens needs to give its next token:
    2 × the matrix parameters × s; the head at the last position only
    (2·d·vocab); causal attention's QK and PV products within the window
    (4·heads·head_dim flops per query-key pair, s(s+1)/2 pairs); and per
    spectral layer the mixer's causal convolution by transforms at its need
    (per channel a real FFT of the linear-convolution length s + Lf − 1, its
    inverse, and the spectrum product).  The filters' spectra are weights'
    transforms and are not counted."""
    d = cfg["hidden_size"]
    heads = cfg["num_attention_heads"]
    hd = d // heads
    window = cfg.get("sliding_window") or s
    flops = 2.0 * lm_matrix_params(cfg) * s + 2.0 * d * cfg["vocab_size"]
    pairs = sum(min(t + 1, window) for t in range(s)) if window < s else s * (s + 1) / 2
    n_lin = s + cfg["spectral_filter_len"] - 1
    for kind in layer_kinds(cfg):
        if kind == "attn":
            flops += 4.0 * heads * hd * pairs
        else:
            flops += d * (2 * fft_flops(n_lin, real=True) + 6.0 * (n_lin // 2 + 1))
    return flops
