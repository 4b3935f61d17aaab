"""The frozen references against the port's plain CPU route at a tiny size.
The tests import both sides; the references import nothing of the port."""

import pb_tiny
import pytest
import torch

from portbench import common
from portbench.reference import danube, sar


def test_stripmap_reference_matches_the_port():
    from repro_torch.core import fft

    gen = torch.Generator().manual_seed(0)
    raw = torch.complex(torch.randn(64, 200, generator=gen), torch.randn(64, 200, generator=gen))
    pulse = torch.complex(torch.randn(31, generator=gen), torch.randn(31, generator=gen))
    n = 256  # a power of two past 200 + 31 − 1
    fwd = fft.plan(fft.FFTSpec(n=n), device="cpu")
    inv = fft.plan(fft.FFTSpec(n=n, kind="ifft"), device="cpu")
    xr, xi = fwd.apply_planes(*(torch.nn.functional.pad(t, (0, n - 200)) for t in (raw.real, raw.imag)))
    hr, hi = fwd.apply_planes(*(torch.nn.functional.pad(t, (0, n - 31)) for t in (pulse.real, pulse.imag)))
    yr, yi = inv.apply_planes(xr * hr + xi * hi, xi * hr - xr * hi)  # X · conj(H)
    az = fft.plan(fft.FFTSpec(n=64, kind="fft", axis=-2), device="cpu")
    ar, ai = az.apply_planes(yr[:, :200].contiguous(), yi[:, :200].contiguous())
    want = sar.stripmap_image(raw, pulse)
    got = torch.hypot(ar, ai)
    assert want.dtype == torch.float64
    assert float((got - want).abs().max() / want.abs().max()) < 1e-5


def test_spotlight_and_batched_references_match_the_port():
    from repro_torch.core import fft

    gen = torch.Generator().manual_seed(1)
    ph = torch.complex(torch.randn(32, 64, generator=gen), torch.randn(32, 64, generator=gen))
    got = fft.plan(fft.FFTSpec(n=64, kind="fft2", n2=32), device="cpu")(ph).abs() / (32 * 64)
    want = sar.spotlight_image(ph)
    assert float((got - want).abs().max() / want.abs().max()) < 1e-5
    x = ph[:3]
    got = fft.plan(fft.FFTSpec(n=64), device="cpu")(x)
    want = sar.batched_fft(x)
    assert float((got - want).abs().max() / want.abs().max()) < 1e-5


def test_bfloat16_control_departs_from_the_reference():
    gen = torch.Generator().manual_seed(2)
    raw = torch.complex(torch.randn(64, 256, generator=gen), torch.randn(64, 256, generator=gen))
    pulse = torch.complex(torch.randn(31, generator=gen), torch.randn(31, generator=gen))
    want = sar.stripmap_image(raw, pulse)
    low = sar.stripmap_image(raw, pulse, "bfloat16")
    assert 1e-4 < float((low - want).abs().max() / want.abs().max()) < 5e-2


def tiny_danube(compute_dtype):
    cfg = {**common.config("h2o-danube-1.8b-spectral"), **pb_tiny.LM["config"], "compute_dtype": compute_dtype}
    driver = common.load("drivers", "lm_prefill")
    from repro_torch.models.model import DecoderLM

    weights = danube.make_weights(cfg, 5, "cpu")
    model = DecoderLM(driver.model_config(cfg), device="meta")
    model.load_state_dict(weights, strict=True, assign=True)
    return cfg, weights, model


@pytest.mark.parametrize("s", [24, 40])  # one q block, and the chunked path past the threshold
def test_danube_reference_matches_the_port_in_float32(s):
    cfg, weights, model = tiny_danube("float32")
    tokens = torch.randint(cfg["vocab_size"], (1, s), generator=torch.Generator().manual_seed(s))
    got, _ = model.prefill(tokens)
    want = danube.forward(weights, cfg, tokens[0], q_block=16)
    assert danube.rel_l2(got[0], want) < 1e-5


@pytest.mark.parametrize("s", [24, 40])
def test_danube_reference_sublayers_match_the_port_at_every_position(s):
    """What the check compares besides the logits: every block's mixer and
    MLP output at every position, as the driver's hooks keep them."""
    cfg, weights, model = tiny_danube("float32")
    driver = common.load("drivers", "lm_prefill")
    tokens = torch.randint(cfg["vocab_size"], (1, s), generator=torch.Generator().manual_seed(s + 1))
    kept = {}
    with driver.capture(model, kept):
        model.prefill(tokens)
    errs, each = driver.layer_errs(kept)
    danube.forward(weights, cfg, tokens[0], q_block=16, each=each)
    assert set(errs) == set(kept) and len(errs) == 2 * cfg["num_hidden_layers"]
    assert max(errs.values()) < 1e-5


def test_danube_weights_are_the_ports_parameters_by_name_and_shape():
    cfg, weights, model = tiny_danube("bfloat16")
    params = dict(model.named_parameters())
    assert set(params) == set(weights)
    for name, p in params.items():
        assert p.shape == weights[name].shape and p.data_ptr() == weights[name].data_ptr()


def test_danube_file_is_the_ports_config_with_the_mixer():
    """The file holds the source's published numbers (its config.json), and
    the port's model is built from them, with the mixer on."""
    source = {"hidden_size": 2560, "intermediate_size": 6912, "num_hidden_layers": 24, "num_attention_heads": 32,
              "num_key_value_heads": 8, "vocab_size": 32000, "sliding_window": 4096, "rope_theta": 10000.0,
              "rms_norm_eps": 1e-5, "hidden_act": "silu", "tie_word_embeddings": False}
    cfg = common.config("h2o-danube-1.8b-spectral")
    assert {k: cfg[k] for k in source} == source and cfg["reduced"] == []
    driver = common.load("drivers", "lm_prefill")
    ours = driver.model_config(cfg)
    for key, field in driver.MODEL_FIELDS.items():
        assert getattr(ours, field) == cfg[key], field
    assert ours.use_spectral_mixer and ours.pattern() == ("spectral", "attn") * 12


def test_fp8_control_departs_more_than_bf16_rounding():
    cfg, weights, model = tiny_danube("bfloat16")
    tokens = torch.randint(cfg["vocab_size"], (40,), generator=torch.Generator().manual_seed(9))
    want = danube.forward(weights, cfg, tokens, q_block=16)
    low = danube.forward(weights, cfg, tokens, cast="fp8", q_block=16)
    got, _ = model.prefill(tokens[None])
    assert danube.rel_l2(low, want) > 2 * danube.rel_l2(got[0], want)
