"""The yardstick's need counts against hand-worked values."""

import math

import pb_tiny  # noqa: F401
import pytest

from portbench import common, need


def test_stripmap_block_need():
    n = need.stripmap_need(4096, 5616, 704)
    # The complex64 raw block read once and the float32 image written once.
    assert n["bytes"] == (8 + 4) * 4096 * 5616 == 276_037_632
    # A complex FFT and its inverse of each of 4096 echo lines at 6319
    # points (5·n·log2 n each), 6 flops on each of 6319 bins, and a
    # 4096-point complex FFT of each of 5616 columns.
    range_line = 2 * 5 * 6319 * math.log2(6319) + 6 * 6319
    want = 4096 * range_line + 5616 * 5 * 4096 * 12
    assert n["flops"] == pytest.approx(want)
    assert n["flops"] == pytest.approx(4.803e9, rel=1e-3)
    # Bound by bytes: 0.0824 ms against 0.0717 ms of FP32 flops.
    assert n["least_s"] == pytest.approx(276_037_632 / 3.35e12)
    assert need.filter_flops(5616, 704) == pytest.approx(5 * 6319 * math.log2(6319))


def test_danube_matrix_parameters():
    cfg = common.config("h2o-danube-1.8b-spectral")
    attn = 2560 * 2560 * 2 + 2560 * 640 * 2  # wq, wo; wk, wv (8 kv heads of 80)
    spectral = 3 * 2560 * 2560               # w_gate, w_in, w_out
    mlp = 3 * 2560 * 6912
    assert need.lm_matrix_params(cfg) == 12 * (attn + mlp) + 12 * (spectral + mlp)
    assert need.lm_matrix_params(cfg) == 1_706_557_440


def test_danube_prefill_flops_of_2560_tokens():
    cfg = common.config("h2o-danube-1.8b-spectral")
    s = 2560
    matrices = 2 * 1_706_557_440 * s
    head = 2 * 2560 * 32000                              # the last position only
    attention = 12 * 4 * 32 * 80 * s * (s + 1) / 2       # QK and PV over the causal pairs
    n = s + 1024 - 1                                     # the mixer's linear-convolution length
    mixer = 12 * 2560 * (2 * 2.5 * n * math.log2(n) + 6 * (n // 2 + 1))
    want = matrices + head + attention + mixer
    assert need.prefill_flops(cfg, s) == pytest.approx(want)
    assert need.prefill_flops(cfg, s) == pytest.approx(9.147e12, rel=1e-3)


def test_spotlight_and_batched_needs():
    sp = need.spotlight_need(4096, 8192)
    assert sp["bytes"] == 12 * 4096 * 8192
    assert sp["flops"] == pytest.approx(4096 * 5 * 8192 * 13 + 8192 * 5 * 4096 * 12)
    b = need.batched_fft_need(2 ** 20, 64)
    assert b["bytes"] == 16 * 2 ** 20 * 64
    assert b["flops"] == pytest.approx(64 * 5 * 2 ** 20 * 20)


def test_least_time_is_the_larger_term():
    assert need.least_s(3.35e12, 0.0) == pytest.approx(1.0)
    assert need.least_s(0.0, 67e12) == pytest.approx(1.0)
    assert need.least_s(0.0, 989e12, need.PEAKS["bf16_flops_per_s"]) == pytest.approx(1.0)
