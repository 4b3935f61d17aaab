"""Quickstart: the port's plan-and-execute FFT API in five minutes.

The PyTorch/CUDA counterpart of ``examples/quickstart.py``, section for
section.  Everything runs on the card (the hand-written CUDA kernels)
unless ``--device cpu`` asks for the plain PyTorch route; nothing falls
back from one to the other.

  PYTHONPATH=src python examples/quickstart_torch.py               # the card
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu  # plain route
"""

from __future__ import annotations

import argparse
import socket

import numpy as np
import torch
import torch.distributed as dist


def err(got, want) -> float:
    """max |got − want| over numpy's answer, as a float."""
    if isinstance(got, (tuple, list)):
        got = got[0].cpu().numpy() + 1j * got[1].cpu().numpy()
    elif torch.is_tensor(got):
        got = got.detach().cpu().numpy()
    return float(np.abs(got - want).max())


def close(got, want) -> bool:
    """Within 1e-3·max|want| (the repo's tolerance for float32 transforms)."""
    want = want.detach().cpu().numpy() if torch.is_tensor(want) else np.asarray(want)
    return err(got, want) <= 1e-3 * float(np.abs(want).max())


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cpu for the plain route; the card by default")
    args = ap.parse_args(argv)

    from repro_torch.core import fft as F
    from repro_torch.core import plan
    from repro_torch.core.conv import fft_conv

    dev = F._resolve_device(args.device)
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def on(a):
        return torch.as_tensor(a, device=dev)

    # ---- 1. plan inspection: the paper's kernel-call schedule -------------
    for n in (1024, 65536, 2**20):
        print(plan.describe(n))

    # ---- 2. plan-and-execute: resolve a spec once, run it many times ------
    x = (rng.standard_normal((4, 4096)) + 1j * rng.standard_normal((4, 4096))).astype(np.complex64)
    spec = F.FFTSpec(n=4096, kind="fft", batch_hint=4)
    planned = F.plan(spec, device=dev)        # interned: F.plan(spec) is F.plan(spec)
    print(f"planned: {planned.describe()}")
    y = planned(on(x))
    print("max err vs numpy:", err(y, np.fft.fft(x)))

    # ---- 3. the backend registry: every backend asked for the same plan ---
    # ``cuda`` runs the CUDA kernels on the card, ``torch`` their plain
    # versions on the CPU.  The one for this device runs the plan; the
    # other raises PlanError: there is no fallback.
    for backend in F.available_backends():
        try:
            y = F.plan(spec, device=dev, backend=backend)(on(x))
            print(f"backend={backend:6s} on {dev}: max err vs numpy: {err(y, np.fft.fft(x)):.2e}")
        except F.PlanError as e:
            print(f"backend={backend:6s} on {dev}: refused: {e}")

    # ---- 4. scoped backend selection (the deprecated global setter's successor)
    own = "cuda" if dev.type == "cuda" else "torch"
    with F.use_backend(own):
        y = F.fft(on(x))                      # wrappers are plan-cached too
        print(f"use_backend({own!r}) err:", err(y, np.fft.fft(x)), "default:", F.default_backend())
    other = "torch" if own == "cuda" else "cuda"
    try:
        with F.use_backend(other):
            F.fft(on(x))
    except F.PlanError as e:
        print(f"use_backend({other!r}) on {dev}: refused: {e}")

    # ---- 5. axis-aware transforms (no manual movedim) ---------------------
    xa = (rng.standard_normal((8, 1024, 3)) + 1j * rng.standard_normal((8, 1024, 3))).astype(np.complex64)
    ya = F.fft(on(xa), axis=1)
    print("axis=1 err:", err(ya, np.fft.fft(xa, axis=1)))

    # ---- 6. real FFT (half the work for real signals) ---------------------
    sig = rng.standard_normal((2, 8192)).astype(np.float32)
    Xr, Xi = F.rfft(on(sig))
    print("rfft bins:", tuple(Xr.shape), " roundtrip err:", err(F.irfft((Xr, Xi), 8192), sig))

    # ---- 7. FFT long convolution (the LM-layer integration) ---------------
    u = rng.standard_normal((1, 16, 2048)).astype(np.float32)  # (B, D, L)
    h = rng.standard_normal((16, 2048)).astype(np.float32)     # per-channel filters
    yc = fft_conv(on(u), on(h))
    print("fft_conv out:", tuple(yc.shape))

    # ---- 8. composed with autograd -----------------------------------------
    # Torch's gradient of a real loss with respect to a complex input is
    # ∂L/∂Re z + i·∂L/∂Im z, the conjugate of JAX's convention: for the
    # spectral energy Σ|F x|² = N·Σ|x|² torch gives 2N·x where JAX's grad
    # gives 2N·conj(x).
    v = on(x).requires_grad_()
    (F.fft(v).abs() ** 2).sum().backward()
    print("grad of spectral energy == 2N·x (torch; JAX: 2N·conj(x)):", close(v.grad, 2 * 4096 * v.detach()))

    # ---- 9. 2-D images: one joint rows+columns pass program ----------------
    img = (rng.standard_normal((128, 1024)) + 1j * rng.standard_normal((128, 1024))).astype(np.complex64)
    p2 = F.plan(F.FFTSpec(n=1024, kind="fft2", n2=128), device=dev)  # ONE program
    print("fft2 plan:", p2.describe())
    print("fft2 err vs numpy:", err(p2(on(img)), np.fft.fft2(img)))
    real_img = rng.standard_normal((128, 1024)).astype(np.float32)
    Br, Bi = F.rfft2(on(real_img))                                    # real-packing 2-D
    print("rfft2 bins:", tuple(Br.shape), " roundtrip err:", err(F.irfft2((Br, Bi), 1024, 128), real_img))

    # ---- 10. overlap-save streaming convolution ----------------------------
    # Long signals never plan past the fused regime: the signal is blocked
    # into overlapping segments batched through ONE cached small plan pair,
    # and StreamingConv carries the Lh-1 tail so chunked calls compose.
    from repro_torch.core.overlap import StreamingConv, fft_conv_os

    sig = on(rng.standard_normal((2, 1 << 16)).astype(np.float32))
    filt = on(rng.standard_normal(1025).astype(np.float32))
    y_os = fft_conv_os(sig, filt)
    print("fft_conv_os out:", tuple(y_os.shape))
    sc = StreamingConv(filt)                  # block picked from Lh
    state = sc.init_state((2,))
    chunks = []
    for start in range(0, sig.shape[-1], 1 << 14):
        yk, state = sc(sig[:, start:start + (1 << 14)], state)
        chunks.append(yk)
    print("streaming == one-shot:", close(torch.cat(chunks, -1), y_os))

    # ---- 11. autotuning: measured plan tuning with a persistent cache ------
    # The roofline model prunes the candidates, tune="measure" times the
    # survivors ONCE on the card and keeps the winner; a warm plan (and a
    # later process) reads the cache and measures nothing.  The CPU route
    # runs the heuristic program whatever the mode.
    from repro_torch.core import tuning

    y_tuned = fft_conv_os(sig, filt, tune="measure")
    print("tuned block == one-shot result:", close(y_tuned, y_os))
    pt = F.plan(F.FFTSpec(n=2**17, kind="fft"), device=dev, tune="measure")
    print("tuned plan:", pt.describe())
    print("tuning cache:", tuning.cache_path())       # REPRO_TUNING_CACHE overrides
    print("measurements this process:", len(tuning.measure_log()))
    pt2 = F.plan(F.FFTSpec(n=2**17, kind="fft"), device=dev, tune="measure")
    print("second plan is the same handle (zero re-measurement):", pt2 is pt)

    # ---- 12. streaming spectral serving: prefill / insert / generate -------
    # A request joins a RUNNING batch (the spectral mixer's stream state is
    # re-phased to the batch's chunk clock, so a late joiner decodes as it
    # would alone), and a warm loop plans no new FFT.
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models.model import DecoderLM
    from repro_torch.serving.engine import Engine, ServeConfig
    from repro_torch.serving.spectral_serve import ServeSession

    cfg = ModelConfig(
        family="dense", num_layers=2, d_model=32, num_heads=2, num_kv_heads=2,
        d_ff=64, vocab_size=128, block_pattern=("spectral", "attn"),
        spectral_filter_len=8, compute_dtype="float32",
    )
    with torch.no_grad():
        model = DecoderLM(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
        eng = Engine(model, ServeConfig(max_new=6))
        prompts = torch.randint(4, cfg.vocab_size, (2, 8), generator=gen, device=dev)
        sess = ServeSession(eng, slots=2, max_len=16)
        s0 = sess.submit(prompts[0])   # prefill + insert into slot 0
        sess.run(2)                    # slot 0 decodes alone for 2 steps
        s1 = sess.submit(prompts[1])   # joins the RUNNING batch mid-stream
        sess.run(5)                    # both slots advance
        print("slot0 tokens:", sess.output(s0)[:6])
        print("slot1 tokens:", sess.output(s1)[:6])
        solo = eng.generate(prompts)   # whole-batch convenience wrapper
        print("mid-stream join == solo decode:", sess.output(s1)[:6] == solo[1].tolist())
        F.clear_plan_log()
        sess.run(3)                    # warm loop: every flush hits the plan cache
    print("new FFT plans during warm generate:", len(F.plan_log()))
    print("phase seconds:", {k: round(v, 4) for k, v in sess.phase_s.items()})

    # ---- 13. distributed pencil FFT: tuned, packed, overlapped -------------
    # Over a process group the slow tier is the all-to-all transpose, and
    # the schedule is a modelled decision (factor balance, packing the
    # split-complex pair into one collective, the chunk count K), the same
    # on every rank.  Here one rank: a group this example starts itself
    # (NCCL on the card, gloo on the CPU) and ends before it returns.
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.core import distributed as D

    owned = not dist.is_initialized()
    if owned:
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=f"tcp://localhost:{free_port()}", world_size=1, rank=0)
    try:
        mesh = init_device_mesh(dev.type, (dist.get_world_size(),))
        xr = torch.randn(2, 4096, generator=gen, device=dev)
        dr = distribute_tensor(xr, mesh, [Shard(1)])
        yr, yi = D.pfft_sharded(dr, distribute_tensor(torch.zeros_like(xr), mesh, [Shard(1)]), tune="model")
        # This rank's columns of the spectrum, against numpy's.
        width = 4096 // dist.get_world_size()
        want = np.fft.fft(xr.cpu().numpy().astype(np.float64))[:, dist.get_rank() * width:][:, :width]
        print("pfft matches np.fft:", close((yr.to_local(), yi.to_local()), want))
    finally:
        if owned:
            dist.destroy_process_group()
    # The plan prints the pencil schedule like a local plan: factors,
    # collectives, modelled bytes a transpose.  One shard collapses to the
    # local plan (zero collectives); at d = 8 the same call runs 3 packed
    # all-to-alls.
    print("d=1:", D.plan_pencil(4096, 1, device=dev).describe().splitlines()[0])
    print("d=8:", D.plan_pencil(1 << 18, 8, device=dev).describe().splitlines()[0])

    # ---- 14. the card's budget and the plan's forms -------------------------
    # The reference's pallas_gpu backend sized Triton tiles by a device's
    # shared memory; the port's CUDA kernels take the H100's per-block
    # opt-in budget (limits.memory_budget: 227 KiB), and each column or row
    # pass runs in a form (an on-chip tile of 2^12–2^14 points, or the slab
    # four-step) that the tuner picks within it.  One backend claims every
    # pass: a kernel that cannot run raises, it does not fall back.
    from repro_torch.core import limits
    from repro_torch.kernels import ops, pencil

    pg = F.plan(F.FFTSpec(n=131072), device=dev)
    print("per-pass claims:", pg.pass_claims)
    print(pg.describe())
    forms = pg.forms or {i: pencil.table_form(k, f) for i, (k, f) in ops.form_passes(pg.fft_plan).items()}
    print("forms (pass: log2 tile, 0 = slab):", forms)
    xg = torch.randn(2, 131072, generator=gen, device=dev)
    print("131072-point plan matches np.fft:", close(pg(xg), np.fft.fft(xg.cpu().numpy())))
    print("smem budget here:", limits.memory_budget(dev) // 1024, "KiB;",
          "H100:", limits.memory_budget("NVIDIA H100 80GB HBM3") // 1024, "KiB;",
          "A100:", limits.memory_budget("NVIDIA A100-SXM4-40GB") // 1024, "KiB")

    # ---- 15. arbitrary lengths: the Bluestein chirp-conv passes ------------
    # FFTSpec takes ANY n ≥ 1; a non-power-of-two length is a chirp
    # convolution at a power-of-two pad, 2 passes in the fused regime.
    from repro_torch.analysis import roofline as rl

    pb = F.plan(F.FFTSpec(n=2029), device=dev)           # prime length
    print(pb.describe())
    xb = torch.randn(2, 2029, generator=gen, device=dev)
    print("prime-n matches np.fft:", close(pb(xb), np.fft.fft(xb.cpu().numpy())))
    rep = rl.bluestein_report(2029)
    print("bluestein tax: pad %d (%.2fx), %.1fx flops vs mixed-radix"
          % (rep["pad"], rep["pad_ratio"], rep["flops_overhead"]))

    # ---- 16. fault tolerance: injection and the numerics guards ------------
    # The port does not degrade: a kernel that fails raises KernelError
    # (the reference retries, quarantines and falls back to XLA).  An
    # injected kernel.launch fault shows it; the opt-in guards check the
    # result: check="nan" scans it, check="parseval" its energy.
    from repro_torch.core import faults

    pf = F.plan(F.FFTSpec(n=4096, batch_hint=2), device=dev)
    xf = torch.randn(2, 4096, generator=gen, device=dev).to(torch.complex64)
    try:
        with faults.inject_fault("kernel.launch", times=1):
            pf(xf)
        print("injected fault: not raised")
    except faults.KernelError as e:
        print("injected fault raises KernelError:", e)
    pf(xf, check="parseval")
    pf(xf, check="nan")
    print("check='parseval' and check='nan' pass")


if __name__ == "__main__":
    main()
