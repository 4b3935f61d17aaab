"""SAR image formation on the port's planned FFT API (paper §3 motivation).

The PyTorch/CUDA counterpart of ``examples/sar_imaging.py``: the same three
scenes, each a function of its sizes that returns its image, run through
the port's plan handles on the card (``--device cpu``: the plain route).

1. **Stripmap range–Doppler** (:func:`stripmap`): real raw returns are
   range-compressed with an LFM matched filter via ``fft_conv2d`` (one
   cached rfft2/irfft2 plan pair), then azimuth-compressed with a planned
   ``axis=-2`` FFT, the in-place column pass: no transposes anywhere.
2. **Spotlight (dechirped) phase history** (:func:`spotlight`): after
   dechirp-on-receive the image *is* the 2-D FFT of the phase history, so
   image formation is ONE planned ``fft2`` handle.
3. **Prime range line** (:func:`range_lines`): a 2029-sample line (a
   prime) plans as Bluestein passes, and ``fft_conv(pad="exact")`` keeps
   the spectrum bin-aligned to the true linear-convolution length.

Each scene's data is drawn from a seeded ``torch.Generator`` on the scene's
device; :func:`main` runs the reference example's sizes and prints its
OK/MISS lines and plan reports (``roofline.fft_pass_report``).

  PYTHONPATH=src python examples/sar_imaging_torch.py               # the card
  PYTHONPATH=src python examples/sar_imaging_torch.py --device cpu  # plain route
"""

from __future__ import annotations

import argparse
import math

import torch

from repro_torch.analysis import roofline as rl
from repro_torch.core import fft as F
from repro_torch.core.conv import fft_conv, fft_conv2d
from repro_torch.core.limits import next_pow2

#: The reference example's scenes: stripmap (pulses, range samples, chirp
#: samples), its (azimuth frequency, range) targets; spotlight (pulses,
#: range bins) and its (azimuth bin, range bin) targets; the prime range
#: line (samples, chirp samples) and its echo offsets.
STRIPMAP = (256, 2048, 256)
STRIPMAP_TARGETS = ((0.10, 500), (0.25, 1200), (0.40, 300))
SPOTLIGHT = (512, 4096)
SPOTLIGHT_TARGETS = ((64, 700), (200, 2048), (400, 3500))
RANGE_LINE = (2029, 64)
RANGE_OFFSETS = (173, 611, 1301, 1949)


def chirp(length: int, rate: float, device) -> torch.Tensor:
    """A real LFM pulse cos(rate·t²) of ``length`` samples (float64 phase)."""
    t = torch.arange(length, dtype=torch.float64, device=device)
    return torch.cos(rate * t * t).to(torch.float32)


def stripmap_targets(n_rg: int) -> tuple:
    """The reference's targets, range offsets scaled to ``n_rg`` samples."""
    return tuple((fa, rg0 * n_rg // STRIPMAP[1]) for fa, rg0 in STRIPMAP_TARGETS)


def stripmap_raw(n_az: int, n_rg: int, chirp_len: int, targets, gen: torch.Generator):
    """(raw returns (n_az, n_rg), matched filter (chirp_len,)): each target
    a range-delayed chirp echo under a cosine azimuth modulation, plus
    noise.  The chirp's rate keeps the reference's rate·length (its
    bandwidth) at any ``chirp_len``."""
    dev = gen.device
    pulse = chirp(chirp_len, 0.512 / chirp_len, dev)
    raw = torch.zeros(n_az, n_rg, device=dev)
    a = torch.arange(n_az, dtype=torch.float64, device=dev)
    for fa, rg0 in targets:
        az_mod = torch.cos(2 * math.pi * fa * a).to(torch.float32)
        raw[:, rg0:rg0 + chirp_len] += az_mod[:, None] * pulse[None, : n_rg - rg0]
    raw += torch.randn(n_az, n_rg, generator=gen, device=dev) * 0.05
    return raw, pulse.flip(0).contiguous()


def stripmap_image(raw: torch.Tensor, matched: torch.Tensor) -> torch.Tensor:
    """|azimuth FFT of the range-compressed returns|: ``fft_conv2d`` with a
    (1, Lh) matched filter, then the planned ``axis=-2`` FFT in place."""
    rc = fft_conv2d(raw, matched[None, :], mode="same")
    az_plan = F.plan(F.FFTSpec(n=raw.shape[-2], kind="fft", axis=-2), device=raw.device)
    ar, ai = az_plan.apply_planes(rc, torch.zeros_like(rc))
    return torch.hypot(ar, ai)


def stripmap_found(image: torch.Tensor, targets, chirp_len: int) -> list:
    """Per target: (ok, az peak, expected, range peak, expected) — the
    matched-filter peak within 8 range samples, the azimuth tone within 2
    bins (DC skipped, one side)."""
    n_az = image.shape[-2]
    col_max = image.max(dim=0).values
    out = []
    for fa, rg0 in targets:
        expect_rg = rg0 + chirp_len - 1
        lo, hi = expect_rg - 64, expect_rg + 64
        rg_peak = int(torch.argmax(col_max[lo:hi])) + lo
        az_peak = int(torch.argmax(image[1: n_az // 2, rg_peak])) + 1
        expect_az = int(round(fa * n_az))
        ok = abs(rg_peak - expect_rg) <= 8 and abs(az_peak - expect_az) <= 2
        out.append((ok, az_peak, expect_az, rg_peak, expect_rg))
    return out


def stripmap(n_az: int, n_rg: int, chirp_len: int, *, device, seed: int = 0):
    """Scene 1 at (n_az pulses, n_rg range samples, chirp_len): returns
    (image, raw, matched filter, targets)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    targets = stripmap_targets(n_rg)
    raw, matched = stripmap_raw(n_az, n_rg, chirp_len, targets, gen)
    return stripmap_image(raw, matched), raw, matched, targets


def spotlight_targets(n_az: int, n_rg: int) -> tuple:
    """The reference's targets, bins scaled to an (n_az, n_rg) scene."""
    return tuple((az0 * n_az // SPOTLIGHT[0], rg0 * n_rg // SPOTLIGHT[1]) for az0, rg0 in SPOTLIGHT_TARGETS)


def spotlight_history(n_az: int, n_rg: int, targets, gen: torch.Generator) -> torch.Tensor:
    """The dechirped phase history: one 2-D complex sinusoid per target
    (phase in float64), plus complex noise; complex64 (n_az, n_rg)."""
    dev = gen.device
    a = torch.arange(n_az, dtype=torch.float64, device=dev)[:, None] / n_az
    r = torch.arange(n_rg, dtype=torch.float64, device=dev)[None, :] / n_rg
    ph = torch.zeros(n_az, n_rg, dtype=torch.complex64, device=dev)
    for az0, rg0 in targets:
        ang = 2 * math.pi * (az0 * a + rg0 * r)
        ph += torch.complex(torch.cos(ang), torch.sin(ang)).to(torch.complex64)
    noise = torch.randn(2, n_az, n_rg, generator=gen, device=dev) * 0.05
    return ph + torch.complex(noise[0], noise[1])


def spotlight_image(ph: torch.Tensor) -> torch.Tensor:
    """|fft2(phase history)| / (n_az·n_rg): ONE planned fft2 handle."""
    n_az, n_rg = ph.shape[-2:]
    fft2_plan = F.plan(F.FFTSpec(n=n_rg, kind="fft2", n2=n_az), device=ph.device)
    return fft2_plan(ph).abs() / (n_az * n_rg)


def spotlight_found(image: torch.Tensor, targets) -> list:
    """Per target: (ok, |X| at its bin) — the peak of its 9 × 9 window at
    its bin, above 0.5."""
    out = []
    for az0, rg0 in targets:
        win = image[az0 - 4: az0 + 5, rg0 - 4: rg0 + 5]
        peak = divmod(int(torch.argmax(win)), 9)
        value = float(image[az0, rg0])
        out.append((peak == (4, 4) and value > 0.5, value))
    return out


def spotlight(n_az: int, n_rg: int, *, device, seed: int = 1):
    """Scene 2 at (n_az, n_rg): returns (image, phase history, targets)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    targets = spotlight_targets(n_az, n_rg)
    ph = spotlight_history(n_az, n_rg, targets, gen)
    return spotlight_image(ph), ph, targets


def range_raw(n_rg: int, chirp_len: int, offsets, gen: torch.Generator):
    """(lines (len(offsets), n_rg), pulse): one chirp echo per line, noise."""
    dev = gen.device
    pulse = chirp(chirp_len, 0.01, dev)
    line = torch.zeros(len(offsets), n_rg, device=dev)
    for row, rg0 in enumerate(offsets):
        line[row, rg0:rg0 + chirp_len] += pulse[: max(0, min(chirp_len, n_rg - rg0))]
    line += torch.randn(line.shape, generator=gen, device=dev) * 0.02
    return line, pulse


def range_image(line: torch.Tensor, pulse: torch.Tensor) -> torch.Tensor:
    """|matched filter|, its first n samples: ``fft_conv(pad="exact")``
    transforms at the exact linear-convolution length n + Lh − 1 (2092, not
    a power of two) through the Bluestein rfft/irfft."""
    return fft_conv(line, pulse.flip(0).contiguous(), pad="exact").abs()


def range_found(image: torch.Tensor, offsets, chirp_len: int) -> list:
    """Per line: (ok, peak, expected) — the peak within 4 samples."""
    out = []
    for row, rg0 in enumerate(offsets):
        pk = int(torch.argmax(image[row]))
        expect = rg0 + chirp_len - 1
        out.append((abs(pk - expect) <= 4, pk, expect))
    return out


def range_lines(n_rg: int, chirp_len: int, *, device, seed: int = 2):
    """Scene 3, an echo at each of :data:`RANGE_OFFSETS`: returns (image,
    lines, pulse)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    line, pulse = range_raw(n_rg, chirp_len, RANGE_OFFSETS, gen)
    return range_image(line, pulse), line, pulse


def report_scene(name: str, n_az: int, n_rg: int, note: str = "") -> None:
    rep = rl.fft_pass_report(n_rg, batch=1, n2=n_az)
    print(f"[{name}] {note or 'scene'} {n_az}x{n_rg}: {rep['hbm_round_trips']} passes, "
          f"modeled HBM {rep['modeled_hbm_bytes'] / 1e9:.4f} GB")


def main(argv=None) -> bool:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cpu for the plain route; the card by default")
    args = ap.parse_args(argv)
    device = F._resolve_device(args.device)

    n_az, n_rg, chirp_len = STRIPMAP
    image1, _, _, targets = stripmap(n_az, n_rg, chirp_len, device=device)
    report_scene("stripmap", next_pow2(n_az), next_pow2(n_rg + chirp_len - 1),
                 note="per transform of the matched-filter rfft2/irfft2 pair, padded")
    print(f"[stripmap] + 1 azimuth pass (planned axis=-2 FFT, n={n_az})")
    img = image1.cpu()
    print("stripmap image:", tuple(img.shape), "dynamic range: %.1f dB"
          % (20 * math.log10(float(img.max()) / (float(img.median()) + 1e-6))))
    hits = stripmap_found(img, targets, chirp_len)
    for (fa, rg0), (ok, az_pk, want_az, rg_pk, want_rg) in zip(targets, hits):
        print(f"  target (fa={fa:.2f}, rg={rg0:4d}): peak at (az {az_pk:3d}/{want_az:3d}, "
              f"rg {rg_pk:4d}/{want_rg:4d}) {'OK' if ok else 'MISS'}")

    n_az2, n_rg2 = SPOTLIGHT
    image2, _, targets2 = spotlight(n_az2, n_rg2, device=device)
    print("\nspotlight plan:", F.plan(F.FFTSpec(n=n_rg2, kind="fft2", n2=n_az2), device=device).describe())
    report_scene("spotlight", n_az2, n_rg2)
    found2 = spotlight_found(image2.cpu(), targets2)
    for (az0, rg0), (ok, value) in zip(targets2, found2):
        print(f"  target (az={az0:3d}, rg={rg0:4d}): |X|={value:.2f} {'OK' if ok else 'MISS'}")

    n_rg3, chirp3 = RANGE_LINE
    image3, _, _ = range_lines(n_rg3, chirp3, device=device)
    print("\nprime range-line plan:", F.plan(F.FFTSpec(n=n_rg3, kind="fft"), device=device).describe())
    found3 = range_found(image3.cpu(), RANGE_OFFSETS, chirp3)
    for row, (ok, pk, expect) in enumerate(found3):
        print(f"  range line {row}: peak {pk:4d}/{expect:4d} {'OK' if ok else 'MISS'}")
    return all(h[0] for h in hits + found2 + found3)


if __name__ == "__main__":
    main()
