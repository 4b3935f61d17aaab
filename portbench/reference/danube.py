"""h2o-danube-1.8b with spectral mixing: the plain forward in float32.

The equations are read from the port's layers (``repro_torch/models``) and
written out again here; nothing of the program is imported.  A decoder of
``num_hidden_layers`` pre-norm residual blocks; with ``use_spectral_mixer``
the layers alternate (spectral, attention) from the first:

    x      = table[tokens] · √d                       (the port's embedding scale)
    block  : x += mixer(rms(x) · s1);  x += mlp(rms(x) · s2)
    attn   : q = h·Wq, k = h·Wk, v = h·Wv (GQA: head i reads kv head i // (H/KV)),
             RoPE on q and k (split halves, θ = rope_theta), causal softmax(q·kᵀ/√hd)·v, ·Wo
    mixer  : u = h·Win, g = silu(h·Wgate), y[t, c] = Σ_j filt[c, j]·u[t − j, c],
             out = (y ⊙ g)·Wout
    mlp    : (silu(h·Wgate) ⊙ h·Wup)·Wo
    logits = rms(x[last]) · s_final · Whead            (float32)

:func:`forward` also hands each sub-layer's output (mixer, MLP) at every
position to a callback, for the comparison of every position the program
computed.
    rms(x) = x / √(mean(x²) + eps)

Everything runs in float32 with TF32 off (:func:`tf32_off`); attention runs
in blocks of queries and the mixer's causal convolution through
``torch.fft`` at a power of two covering the linear convolution.  With
``cast=fp8`` (the control) every matrix product's two operands and the
convolution's input are rounded to fp8 e4m3 (per-tensor absmax scaling)
first, the step below the configuration's bf16 compute.

:func:`make_weights` draws the parameters from a seed on the device in a few
large calls, at the port's initialisation law, named as the port's
``DecoderLM`` names them; the benchmark hands the same tensors to the
program and to this reference.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional

import torch
import torch.nn.functional as tF

FP8_MAX = 448.0  # the largest finite float8_e4m3fn


def exact(x: torch.Tensor) -> torch.Tensor:
    return x


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor absmax scale, back in float32."""
    scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


CASTS = {"float32": exact, "fp8": fp8}


@contextlib.contextmanager
def tf32_off():
    """Full float32 matrix products and convolutions for the duration."""
    mm, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = mm, cudnn


def layer_kinds(cfg: dict) -> list:
    n = cfg["num_hidden_layers"]
    if cfg.get("use_spectral_mixer"):
        return ["spectral" if i % 2 == 0 else "attn" for i in range(n)]
    return ["attn"] * n


def param_specs(cfg: dict) -> list:
    """(name, shape, law) of every parameter, in the port's names and
    layouts; ``law`` is ("normal", scale), ("ones",) or ("filter",)."""
    d, f, v = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    heads, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = d // heads
    lf = cfg["spectral_filter_len"]
    specs = [("embed.table", (v, d), ("normal", 1.0))]
    for layer, kind in enumerate(layer_kinds(cfg)):
        p = f"stack.{layer}."
        specs.append((p + "norm1.scale", (d,), ("ones",)))
        if kind == "attn":
            specs += [(p + "mixer.wq", (d, heads, hd), ("normal", d ** -0.5)),
                      (p + "mixer.wk", (d, kv, hd), ("normal", d ** -0.5)),
                      (p + "mixer.wv", (d, kv, hd), ("normal", d ** -0.5)),
                      (p + "mixer.wo", (heads, hd, d), ("normal", (heads * hd) ** -0.5))]
        else:
            specs += [(p + "mixer.filt", (d, lf), ("filter",)),
                      (p + "mixer.w_gate", (d, d), ("normal", d ** -0.5)),
                      (p + "mixer.w_in", (d, d), ("normal", d ** -0.5)),
                      (p + "mixer.w_out", (d, d), ("normal", d ** -0.5))]
        specs += [(p + "norm2.scale", (d,), ("ones",)),
                  (p + "mlp.wi_gate", (d, f), ("normal", d ** -0.5)),
                  (p + "mlp.wi_up", (d, f), ("normal", d ** -0.5)),
                  (p + "mlp.wo", (f, d), ("normal", f ** -0.5))]
    specs += [("final_norm.scale", (d,), ("ones",)), ("head.w", (d, v), ("normal", d ** -0.5))]
    return specs


@torch.no_grad()
def make_weights(cfg: dict, seed: int, device) -> dict:
    """Every parameter from ``seed``: one normal draw on ``device`` for all
    the random ones (float32), cut into views and scaled in place; the
    spectral filters' taps N(0, 1/Lf) under the decaying envelope
    exp(−j/τ_c), τ log-spaced from 10 to Lf over the channels; norm scales 1."""
    specs = param_specs(cfg)
    numel = sum(math.prod(shape) for _, shape, law in specs if law[0] != "ones")
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(numel, generator=gen, device=device)
    d, lf = cfg["hidden_size"], cfg["spectral_filter_len"]
    j = torch.arange(lf, dtype=torch.float32, device=device)
    tau = torch.logspace(1.0, math.log10(lf), d, dtype=torch.float32, device=device)
    envelope = torch.exp(-j[None, :] / tau[:, None]) * lf ** -0.5
    out, at = {}, 0
    for name, shape, law in specs:
        if law[0] == "ones":
            out[name] = torch.ones(shape, device=device)
            continue
        n = math.prod(shape)
        t = flat[at:at + n].view(shape)
        at += n
        t.mul_(envelope if law[0] == "filter" else law[1])
        out[name] = t
    return out


def rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, heads, hd) rotated at positions 0 … S − 1; angles in float64."""
    s, _, hd = x.shape
    half = hd // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float64, device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang).float()[:, None, :], torch.sin(ang).float()[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def mm(a: torch.Tensor, b: torch.Tensor, cast: Callable) -> torch.Tensor:
    return cast(a) @ cast(b)


def attention(h, w, prefix, cfg, cast, q_block: int, context=None):
    s, d = h.shape
    heads, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = d // heads
    q = mm(h, w[prefix + "wq"].reshape(d, heads * hd), cast).view(s, heads, hd)
    k = mm(h, w[prefix + "wk"].reshape(d, kv * hd), cast).view(s, kv, hd)
    v = mm(h, w[prefix + "wv"].reshape(d, kv * hd), cast).view(s, kv, hd)
    q, k = rope(q, cfg["rope_theta"]), rope(k, cfg["rope_theta"])
    g = heads // kv
    k, v = k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)  # (S, heads, hd)
    kT, vh = cast(k).permute(1, 2, 0), cast(v).transpose(0, 1)  # (heads, hd, S), (heads, S, hd)
    out = torch.empty(s, heads, hd, device=h.device)
    for s0 in range(0, s, q_block):
        s1 = min(s0 + q_block, s)
        scores = (cast(q[s0:s1]).transpose(0, 1) @ kT[:, :, :s1]) * hd ** -0.5  # (heads, b, s1)
        qpos = torch.arange(s0, s1, device=h.device)[:, None]
        kpos = torch.arange(s1, device=h.device)[None, :]
        hidden = kpos > qpos
        if context is not None:  # a planted fault: keys further back than ``context`` left out
            hidden |= kpos <= qpos - context
        scores = scores.masked_fill(hidden, float("-inf"))
        probs = torch.softmax(scores, dim=-1)
        out[s0:s1] = (cast(probs) @ vh[:, :s1]).transpose(0, 1)
    return mm(out.reshape(s, heads * hd), w[prefix + "wo"].reshape(heads * hd, d), cast)


def causal_conv(u: torch.Tensor, filt: torch.Tensor) -> torch.Tensor:
    """y[t, c] = Σ_j filt[c, j]·u[t − j, c] for u (S, D), filt (D, Lf)."""
    s, lf = u.shape[0], filt.shape[-1]
    n = 1 << (s + lf - 2).bit_length()  # a power of two ≥ S + Lf − 1
    spec = torch.fft.rfft(u.T, n=n) * torch.fft.rfft(filt, n=n)
    return torch.fft.irfft(spec, n=n)[:, :s].T


def spectral(h, w, prefix, cast):
    u = mm(h, w[prefix + "w_in"], cast)
    g = tF.silu(mm(h, w[prefix + "w_gate"], cast))
    y = causal_conv(cast(u), w[prefix + "filt"])
    return mm(y * g, w[prefix + "w_out"], cast)


def mlp(h, w, prefix, cast):
    return mm(tF.silu(mm(h, w[prefix + "wi_gate"], cast)) * mm(h, w[prefix + "wi_up"], cast),
              w[prefix + "wo"], cast)


@torch.no_grad()
def forward(weights: dict, cfg: dict, tokens: torch.Tensor, *, cast: str = "float32", q_block: int = 1024,
            each: Optional[Callable] = None, context: Optional[int] = None) -> torch.Tensor:
    """The (vocab,) float32 logits after the last of ``tokens`` (S,).

    ``each(name, out)``, where given, receives every sub-layer's output at
    every position before it joins the residual stream: ``"<layer>.mixer"``
    and ``"<layer>.mlp"``, (S, d) float32.  ``context`` leaves the keys
    further back than ``context`` positions out of every attention layer
    (a planted fault: the far context lost)."""
    c = CASTS[cast]
    eps = cfg["rms_norm_eps"]
    with tf32_off():
        x = weights["embed.table"][tokens].float() * math.sqrt(cfg["hidden_size"])
        for layer, kind in enumerate(layer_kinds(cfg)):
            p = f"stack.{layer}."
            h = rms(x, weights[p + "norm1.scale"], eps)
            if kind == "attn":
                out = attention(h, weights, p + "mixer.", cfg, c, q_block, context)
            else:
                out = spectral(h, weights, p + "mixer.", c)
            if each is not None:
                each(f"{layer}.mixer", out)
            x = x + out
            out = mlp(rms(x, weights[p + "norm2.scale"], eps), weights, p + "mlp.", c)
            if each is not None:
                each(f"{layer}.mlp", out)
            x = x + out
        last = rms(x[-1:], weights["final_norm.scale"], eps)
        return mm(last, weights["head.w"], c)[0]


def top_gap(ref: torch.Tensor, token: int) -> float:
    """How far the reference's logit of ``token`` lies below its best."""
    return float(ref.max() - ref[token])


def rel_l2(got: torch.Tensor, ref: torch.Tensor) -> float:
    """‖got − ref‖₂ / ‖ref‖₂ over the vocabulary."""
    return float((got.float() - ref).norm() / ref.norm())


def row_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The root mean square over positions of each position's
    ‖got − ref‖₂ / ‖ref‖₂, for (S, d) outputs: every position weighs
    alike, the late ones (that read the far context) as the early ones."""
    diff = (got.float() - ref).square().sum(-1)
    return float((diff / ref.square().sum(-1)).mean().sqrt())
