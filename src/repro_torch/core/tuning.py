"""Roofline-seeded autotuner with a persistent cache of measured winners.

Port of ``repro/core/tuning.py``.  The paper divides the data "reasonably
according to the size of data"; the planner's divisions (the overlap-save
block, the fused-vs-split crossover, the direct-leaf boundary, the
Bluestein pad, the form of each column and row pass) are fixed constants
until a decision here searches them:

1. a :class:`TuningSpace` lists the candidate configs of one decision, the
   fixed heuristic's first;
2. the roofline model (:func:`repro_torch.analysis.roofline.prune_candidates`)
   keeps the candidates within :data:`PRUNE_TOL` of the least modelled HBM
   bytes whose working set fits the device's budget;
3. ``tune="measure"`` times the survivors on the decision's device (CUDA
   events on the card) and records the winner in a persistent JSON cache
   keyed by ``(device, decision, shape)``: the search runs once per card
   and shape.  ``"model"`` takes the modelled pick with no measurement;
   ``"off"`` is the fixed heuristic.

:func:`repro_torch.core.fft.plan`, :func:`repro_torch.core.overlap.fft_conv_os`
and :class:`~repro_torch.core.overlap.StreamingConv` take ``tune=``.  The
default mode comes from ``REPRO_FFT_TUNE`` (``"model"`` when unset) and the
cache file from ``REPRO_TUNING_CACHE`` (default
``~/.cache/repro-torch-fft/tuning.json``): the reference's two variables, so
one setting steers both packages.  The port's cache keys start with
``torch|`` and never meet the reference's in a shared file.

The plan decision is the reference's ``fused_max`` / ``direct_max`` /
``bluestein_pad`` space, with the card's own grid decomposition, the form
of each column and row pass (:data:`repro_torch.kernels.pencil.FORMS`), in
place of the reference's Pallas chunk widths and batch tiles.  Forms do not
move the modelled bytes, so ``"model"`` keeps the table's forms and only
``"measure"`` separates them.  Only the card's backend is tuned: the CPU
route's plain versions have no forms and run the heuristic program, as the
reference's ``xla`` backend does.

The distributed pencil FFT's decisions (:meth:`TuningSpace.for_pencil`,
:func:`pencil_config`: factor balance, the all-to-all chunk count, packing)
and the SPMD block pick (:func:`modeled_block`) are modelled only: no
cache, no measurement, so every rank of a process group derives the same
schedule from the shape alone.

Every timing is appended to :func:`measure_log`, which is how the tests show
that a cache hit measures nothing.
"""

from __future__ import annotations

import json
import os
import time
import warnings
from typing import Callable, Optional

import torch

from repro_torch.core import fake, faults

__all__ = [
    "TUNE_MODES",
    "CACHE_SCHEMA_VERSION",
    "resolve_mode",
    "TuningSpace",
    "TuningCache",
    "cache",
    "cache_path",
    "seed_cache",
    "device_key",
    "plan_config",
    "tuned_block",
    "modeled_block",
    "pencil_config",
    "measure_log",
    "clear_measure_log",
]

TUNE_MODES = ("off", "model", "measure")

#: On-disk cache schema, the reference's: a file of any other version is
#: quarantined as foreign rather than guessed at.
CACHE_SCHEMA_VERSION = 1

#: Modelled-bytes tolerance of the roofline pruning: candidates more than
#: 20% above the least modelled HBM traffic are never measured.
PRUNE_TOL = 0.2

#: Timing discipline of the measurement pass.
MEASURE_REPS = 5
MEASURE_WARMUP = 2

#: A candidate must beat the fixed heuristic by this fraction to replace
#: it: within the margin the measurement is noise, and keeping the default
#: keeps "tuned is never slower than fixed" across noisy re-runs.
DEFAULT_MARGIN = 0.10

#: Survivors are timed in this many interleaved rounds (min across rounds),
#: so slow drift lands on every candidate.
MEASURE_ROUNDS = 2

#: Prefix of every key the port writes, apart from the reference's keys.
KEY_PREFIX = "torch"


def resolve_mode(tune: Optional[str]) -> str:
    """Resolve a ``tune=`` argument: the explicit value, else
    ``REPRO_FFT_TUNE``, else ``"model"``."""
    if tune is None:
        tune = os.environ.get("REPRO_FFT_TUNE") or "model"
    if tune not in TUNE_MODES:
        raise faults.PlanError(f"tune must be one of {TUNE_MODES}, got {tune!r}")
    return tune


# ---------------------------------------------------------------------------
# Persistent cache
# ---------------------------------------------------------------------------


def cache_path() -> str:
    """Resolved per operation, so the environment can redirect it."""
    env = os.environ.get("REPRO_TUNING_CACHE")
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro-torch-fft", "tuning.json")


_SEED_CACHE: Optional[dict] = None


def seed_cache() -> dict:
    """The read-only seed shipped as package data
    (``repro_torch/data/tuning_seed.json``): winners measured on the card,
    layered beneath the user cache so a seeded spec plans tuned with no
    first measurement.  Missing or unreadable package data is empty."""
    global _SEED_CACHE
    if _SEED_CACHE is None:
        data: dict = {}
        try:
            from importlib import resources

            loaded = json.loads(resources.files("repro_torch.data").joinpath("tuning_seed.json").read_text())
            if isinstance(loaded, dict):
                data = loaded
        except (OSError, ValueError, ModuleNotFoundError):
            data = {}
        _SEED_CACHE = data
    return _SEED_CACHE


def device_key(device=None) -> str:
    """The hardware half of every cache key: the card's name for a CUDA
    device (None: the current card when there is one), ``"cpu"`` off it.
    A config tuned on one card must not leak onto another."""
    if fake.active():
        return fake.CARD_NAME
    device = torch.device(device) if device is not None else None
    if device is None:
        if not torch.cuda.is_available():
            return "cpu"
        device = torch.device("cuda")
    if device.type != "cuda":
        return device.type
    index = torch.cuda.current_device() if device.index is None else device.index
    return torch.cuda.get_device_name(index).replace("|", "_")


class TuningCache:
    """The persistent winner store: a versioned JSON file
    (``{"version": CACHE_SCHEMA_VERSION, "entries": {...}}``) whose entries
    map ``torch|device|backend|decision|shape`` keys to
    ``{"config": ..., "mode": ...}``.

    Reads are lazy and memoized per path.  Writes re-read the file, merge
    and replace it atomically (temp file + ``os.replace``), so processes
    sharing one file add winners instead of overwriting each other's.  An
    unwritable cache directory falls back to memory.  A corrupt, truncated
    or foreign-schema file is quarantined to a ``.corrupt`` sibling with a
    ``RuntimeWarning`` and the cache rebuilds from the seed.  Pre-versioning
    flat files stay readable.  The ``tuning.cache_read`` /
    ``tuning.cache_write`` fault sites cover both paths."""

    def __init__(self):
        self._mem: dict = {}
        self._loaded_path: Optional[str] = None

    @staticmethod
    def _quarantine_corrupt(path: str, reason: str) -> None:
        corrupt = path + ".corrupt"
        try:
            os.replace(path, corrupt)
            moved = f"quarantined to {corrupt}"
        except OSError:
            moved = "could not quarantine the file"
        warnings.warn(
            f"tuning cache {path} is unusable ({reason}); {moved}; rebuilding from the packaged seed",
            RuntimeWarning,
            stacklevel=3,
        )

    @staticmethod
    def _validate_schema(data, path: str) -> dict:
        """Entries of a loaded cache document, or {} after quarantining a
        foreign-schema file."""
        if (
            isinstance(data, dict)
            and data.get("version") == CACHE_SCHEMA_VERSION
            and isinstance(data.get("entries"), dict)
        ):
            return data["entries"]
        if (
            isinstance(data, dict)
            and "version" not in data
            and all(isinstance(v, dict) and "config" in v for v in data.values())
        ):
            return data  # pre-versioning flat schema, upgraded on the next put()
        version = data.get("version") if isinstance(data, dict) else type(data).__name__
        TuningCache._quarantine_corrupt(path, f"foreign schema (version {version!r})")
        return {}

    @staticmethod
    def _read_file(path: str) -> dict:
        if not os.path.exists(path):
            return {}
        try:
            faults.maybe_fail("tuning.cache_read", path=path)
            with open(path) as f:
                data = json.load(f)
        except faults.TuningCacheError:
            # An injected read fault: as an unreadable file, memory and seed
            # keep serving and nothing is quarantined (the file is fine).
            return {}
        except (json.JSONDecodeError, UnicodeDecodeError, OSError) as err:
            TuningCache._quarantine_corrupt(path, f"{type(err).__name__}: {err}")
            return {}
        return TuningCache._validate_schema(data, path)

    def _load(self) -> dict:
        path = cache_path()
        if self._loaded_path != path:
            self._loaded_path = path
            self._mem = self._read_file(path)
        return self._mem

    def get(self, key: str) -> Optional[dict]:
        hit = self._load().get(key)
        if hit is not None:
            return hit
        # A user-cache miss falls through to the read-only seed; a later
        # put() of the same key shadows it.
        return seed_cache().get(key)

    def put(self, key: str, entry: dict) -> None:
        mem = self._load()
        mem[key] = entry
        path = cache_path()
        try:
            faults.maybe_fail("tuning.cache_write", path=path)
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            # Merge-on-write: another process may have persisted winners
            # since our load; ours win their own keys.
            merged = {**self._read_file(path), **mem}
            doc = {"version": CACHE_SCHEMA_VERSION, "entries": merged}
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=1, sort_keys=True)
            os.replace(tmp, path)
            self._mem = merged
        except (OSError, faults.TuningCacheError):
            pass  # memory-only fallback

    def clear(self) -> None:
        """Drop the in-memory view and the persisted file."""
        self._mem = {}
        self._loaded_path = None
        path = cache_path()
        try:
            if os.path.exists(path):
                os.remove(path)
        except OSError:
            pass


#: The process-wide cache every decision goes through.
cache = TuningCache()


# ---------------------------------------------------------------------------
# Measurement log (how tests show "zero measurements on a cache hit")
# ---------------------------------------------------------------------------

_MEASURE_LOG: list = []


def measure_log() -> tuple:
    """Every timing taken in this process: (decision, key, config)."""
    return tuple(_MEASURE_LOG)


def clear_measure_log() -> None:
    _MEASURE_LOG.clear()


def _time(fn, device, reps: int = MEASURE_REPS, warmup: int = MEASURE_WARMUP) -> float:
    """Seconds of the fastest of ``reps`` calls of ``fn`` after ``warmup``:
    CUDA events around each call on a CUDA ``device``, each ending in a
    synchronisation of the end event (so the interval is the call's and not
    the queue's), the host clock on the CPU."""
    device = torch.device(device)
    for _ in range(warmup):
        fn()
    best = float("inf")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        return best
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def _backend_name(device: torch.device) -> str:
    from repro_torch.core import fft as fft_lib  # lazy: fft plans through here

    return fft_lib._backend_for(device).name


def _resolve(device) -> torch.device:
    from repro_torch.core import fft as fft_lib  # lazy: fft plans through here

    return fft_lib._resolve_device(device)


# ---------------------------------------------------------------------------
# TuningSpace
# ---------------------------------------------------------------------------


class TuningSpace:
    """The candidate configs of ONE decision.

    ``candidates`` is an ordered list of ``(config, modeled_bytes,
    working_set_bytes)`` triples, the fixed heuristic's FIRST, so modelled
    ties keep the heuristic.  ``measure_fn(config)`` times one trial on
    ``device`` and returns seconds; ``budget`` is the working-set bound of
    the feasibility pruning (None: the reference's ``VMEM_BUDGET``).
    """

    def __init__(
        self,
        decision: str,
        key: str,
        candidates: list,
        measure_fn: Optional[Callable] = None,
        budget: Optional[int] = None,
        device=None,
    ):
        if not candidates:
            raise ValueError(f"empty tuning space for {decision} {key}")
        self.decision = decision
        self.key = key
        self.candidates = candidates
        self.measure_fn = measure_fn
        self.budget = budget
        self.device = torch.device("cpu") if device is None else torch.device(device)

    # -- construction ------------------------------------------------------

    @classmethod
    def for_os_block(cls, L: int, Lh: int, batch: int, device=None, chunk: Optional[int] = None):
        """Overlap-save blocks for a ``(batch, L) ⊛ (Lh,)`` convolution on
        ``device`` (None: the card).

        Candidates: every power of two from ``2·next_pow2(Lh)`` up to
        ``FUSED_MAX``, the heuristic :func:`~repro_torch.core.overlap.pick_block`
        first, with the reference's modelled bytes
        (:func:`~repro_torch.analysis.roofline.conv_report`).  Their working
        set is 0: a block's transforms run on the whole-signal kernels,
        whose tiles are fixed and take at most 132 KiB on every card the
        port runs on.  ``chunk`` keys the decision to a streaming call grain
        (``Lh − 1`` carried samples + ``chunk`` fresh ones), measured as
        :class:`~repro_torch.core.overlap.StreamingConv` chunk calls.
        """
        from repro_torch.analysis import roofline as rl
        from repro_torch.core import overlap as ov
        from repro_torch.core.limits import FUSED_MAX, next_pow2

        dev = _resolve(device)
        default = ov.pick_block(Lh)
        blocks = [default]
        b = max(2 * next_pow2(Lh), 2)
        while b <= FUSED_MAX:
            if b != default and b > Lh - 1:
                blocks.append(b)
            b *= 2
        L_call = (chunk + Lh - 1) if chunk else L  # the signal one call sees
        cands = [
            ({"block": blk}, rl.conv_report(L_call, Lh, batch=batch, block=blk)["overlap_save"]["hbm_bytes"], 0)
            for blk in blocks
        ]

        def measure(config):
            gen = torch.Generator(device=dev).manual_seed(0)
            h = torch.randn(Lh, generator=gen, device=dev)
            x = torch.randn(batch, chunk or L, generator=gen, device=dev)
            if chunk:
                sc = ov.StreamingConv(h, block=config["block"], device=dev, tune="off")
                state = sc.init_state((batch,))
                return _time(lambda: sc(x, state), dev)
            return _time(lambda: ov.fft_conv_os(x, h, block=config["block"], device=dev, tune="off"), dev)

        key = f"{_backend_name(dev)}|os_block|L={L},Lh={Lh},batch={batch}"
        if chunk:
            key += f",chunk={chunk}"
        return cls("os_block", key, cands, measure, device=dev)

    @classmethod
    def for_plan(cls, spec, device=None, budget: Optional[int] = None):
        """Whole plan configs for an FFTSpec on the card: the fused-vs-split
        crossover (``fused_max``), the direct-leaf boundary
        (``direct_max``), the Bluestein pad (``bluestein_pad``, non-pow2 1-D
        specs) — the reference's enumeration and modelled bytes — and the
        ``forms`` of the column and row passes (pass index → form): the
        table's, then each pass moved alone to a neighbouring form in
        :data:`~repro_torch.kernels.pencil.FORMS` that fits its length and
        ``budget``.

        ``budget`` (None: :func:`~repro_torch.core.limits.memory_budget` of
        ``device``) bounds each candidate's working set, the shared memory
        of its passes' forms.  A program whose whole-signal four-step pass
        ``fft4step`` cannot run (a factor below its ``MIN_FACTOR``, which
        the reference's ``direct_max`` alternatives reach below n = 1024) is
        no candidate.
        """
        from repro_torch.core import limits
        from repro_torch.core import plan as plan_lib
        from repro_torch.core.limits import DIRECT_MAX, FUSED_MAX
        from repro_torch.kernels import fft4step, ops, pencil

        dev = _resolve(device)
        n, n2 = spec.n, spec.n2
        axis = -2 if spec.axis == -2 else -1
        if budget is None:
            budget = limits.memory_budget(dev)

        def build(fused_max, direct_max=DIRECT_MAX, pad=None):
            if n2 is not None:
                return plan_lib.plan_fft2(n, n2, fused_max, direct_max)
            return plan_lib.plan_fft(n, fused_max, direct_max, pad=pad)

        def modeled(plan):
            shape2d = (n2, n) if n2 is not None else None
            return plan_lib.program_hbm_bytes(plan.passes, spec.batch_hint or 1, shape2d)

        def runs(plan) -> bool:
            kernels = ops.plan_kernels(plan, axis)
            return all(min(p.n1, p.n2) >= fft4step.MIN_FACTOR
                       for p, k in zip(plan.passes, kernels) if k == "fft4step")

        def form_variants(plan):
            takes = ops.form_passes(plan, axis)
            table = {i: pencil.table_form(k, f) for i, (k, f) in takes.items()}
            variants = [table]
            for i, (_k, f) in takes.items():
                at = pencil.FORMS.index(table[i])
                for j in (at - 1, at + 1):
                    if 0 <= j < len(pencil.FORMS):
                        form = pencil.FORMS[j]
                        if pencil.form_fits(f, form) and pencil.form_smem_bytes(form) <= budget:
                            variants.append({**table, i: form})
            return variants

        # Crossover and engine alternatives: only those that change the
        # compiled program (the reference's enumeration).
        fms = [(FUSED_MAX, DIRECT_MAX)]
        for fm in (FUSED_MAX // 2, FUSED_MAX // 4):
            if fm <= DIRECT_MAX:
                continue
            if n2 is not None and not plan_lib.joint2d_supported(n2, fm):
                continue
            if build(fm).passes != build(FUSED_MAX).passes:
                fms.append((fm, DIRECT_MAX))
        for dm in (DIRECT_MAX // 2, DIRECT_MAX // 4):
            if build(FUSED_MAX, dm).passes != build(FUSED_MAX).passes:
                fms.append((FUSED_MAX, dm))
        # The pad alternatives of a non-pow2 1-D spec: the least pad, then
        # its double.
        pads = [None]
        if n2 is None and n & (n - 1):
            m0 = limits.bluestein_pad(n)
            pads = [m0, 2 * m0]
        cands = []
        for pad in pads:
            for fm, dm in fms:
                plan = build(fm, dm, pad)
                if not runs(plan):
                    continue
                for forms in form_variants(plan):
                    cfg = {"fused_max": fm, "direct_max": dm, "forms": {str(i): v for i, v in forms.items()}}
                    if pad is not None:
                        cfg["bluestein_pad"] = pad
                    work = max((pencil.form_smem_bytes(v) for v in forms.values()), default=0)
                    cands.append((cfg, modeled(plan), work))

        inputs = {}

        def measure(config):
            plan = build(config["fused_max"], config.get("direct_max", DIRECT_MAX), config.get("bluestein_pad"))
            forms = {int(k): v for k, v in config["forms"].items()}
            if not inputs:
                b = spec.batch_hint or 2
                shape = (b, n2, n) if n2 is not None else (n, b) if axis == -2 else (b, n)
                gen = torch.Generator(device=dev).manual_seed(0)
                inputs["x"] = (torch.randn(shape, generator=gen, device=dev),
                               torch.randn(shape, generator=gen, device=dev))
            xr, xi = inputs["x"]
            inverse = spec.kind in ("ifft", "ifft2")
            return _time(lambda: ops.execute_plan(xr, xi, plan, inverse=inverse, axis=axis, forms=forms), dev)

        size = f"n={n}" + (f",n2={n2}" if n2 is not None else "") + (",axis=-2" if axis == -2 else "")
        key = f"cuda|plan|{spec.kind}|{size}|batch={spec.batch_hint or 0}"
        return cls("plan", key, cands, measure, budget=budget, device=dev)

    @classmethod
    def for_pencil(cls, n: int, d: int, batch: int = 1, natural_order: bool = True):
        """The distributed pencil FFT's decisions as ONE joint space, the
        reference's candidates in the reference's order: every power-of-two
        split n1·n2 = n with both factors divisible by ``d`` (the balanced
        :func:`~repro_torch.core.distributed.pencil_factors` first), the
        all-to-all chunk count K ∈ {1, 2, 4, 8} the two inner transposes
        are strip-mined into (K | q, packed only), and whether the
        split-complex pair is packed into one collective per transpose.

        Costs are :func:`~repro_torch.analysis.roofline.pencil_report`'s
        ``modeled_s`` at the H100's rates: seconds, since the decision
        trades link time against HBM time.  The working set is the port's
        own: the largest per-block shared memory
        (:func:`~repro_torch.kernels.pencil.form_smem_bytes`) of the table
        forms the two local programs' column and row passes take, where the
        reference's is TPU VMEM; it never reaches the pruning's budget, so
        the pick does not depend on it.  No ``measure_fn``: a per-rank
        timing or cache hit could pick different schedules on different
        ranks and desynchronise the collectives.
        """
        from repro_torch.analysis import roofline as rl
        from repro_torch.core import distributed as dist  # lazy: distributed plans through here

        base = dist.pencil_factors(n, d)
        splits = []
        n1 = 1
        while n1 <= n:
            n2 = n // n1
            if n1 * n2 == n and n1 % d == 0 and n2 % d == 0:
                splits.append((n1, n2))
            n1 *= 2
        if base in splits:  # the balanced factorization first
            splits.remove(base)
        splits.insert(0, base)

        cands = []
        for n1, n2 in splits:
            q = n2 // d
            work = max(_pencil_smem_bytes(n1, -2), _pencil_smem_bytes(n2, -1))
            for pack in (True, False):
                for K in (1, 2, 4, 8):
                    if K > 1 and (not pack or K > q or q % K):
                        continue
                    rep = rl.pencil_report(n, d, batch, n1=n1, n2=n2, pack=pack, chunks=K,
                                           natural_order=natural_order)
                    cfg = {"n1": n1, "n2": n2, "pack": pack, "a2a_chunks": K}
                    cands.append((cfg, rep["modeled_s"], work))
        # The heuristic (balanced, packed, K = 1) leads, so modelled ties
        # keep the simplest schedule.
        cands.sort(key=lambda c: ((c[0]["n1"], c[0]["n2"]) != base, not c[0]["pack"],
                                  c[0]["a2a_chunks"]))
        key = f"cuda|pencil|n={n},d={d},batch={batch},natural={int(natural_order)}"
        return cls("pencil", key, cands, measure_fn=None)

    # -- decision ----------------------------------------------------------

    def decide(self, mode: str) -> dict:
        """The decision at ``mode``; returns a config.

        off     → the fixed heuristic (the first candidate), no cache traffic.
        model   → the roofline-pruned modelled minimum; cached.
        measure → a cache hit returns at once; otherwise the pruned
                  survivors are timed (the heuristic always among them, so
                  the winner is never slower than it beyond the margin) and
                  the winner cached.  A ``model`` entry is re-measured the
                  first time measure runs.
        """
        from repro_torch.analysis.roofline import prune_candidates

        if mode == "off":
            return self.candidates[0][0]
        key = f"{KEY_PREFIX}|{device_key(self.device)}|{self.key}"
        hit = cache.get(key)
        if fake.active():
            # The simulated card times nothing and writes nothing: a cached
            # winner, else the model's pick.
            if hit is not None:
                return hit["config"]
            return prune_candidates(self.candidates, tol=PRUNE_TOL, vmem_budget=self.budget)[0][0]
        if hit is not None and (mode == "model" or hit.get("mode") == "measure"):
            return hit["config"]
        survivors = prune_candidates(self.candidates, tol=PRUNE_TOL, vmem_budget=self.budget)
        if mode == "measure" and self.measure_fn is not None:
            default = self.candidates[0]
            if all(s is not default for s in survivors):
                # The model may prune the heuristic; measurement must still
                # beat it on the clock, not just in modelled bytes.
                survivors = [default] + survivors
            times = [float("inf")] * len(survivors)
            for _round in range(MEASURE_ROUNDS):
                for i, (config, _bytes, _work) in enumerate(survivors):
                    times[i] = min(times[i], self.measure_fn(config))
                    _MEASURE_LOG.append((self.decision, key, json.dumps(config, sort_keys=True)))
            best = min(range(len(survivors)), key=times.__getitem__)
            pick = survivors[best][0]
            t_default = next((times[i] for i, s in enumerate(survivors) if s is default), None)
            if t_default is not None and t_default <= times[best] * (1 + DEFAULT_MARGIN):
                pick = default[0]  # within noise of the heuristic: keep it
        else:
            pick = survivors[0][0]
            mode = "model"
        cache.put(key, {"config": pick, "mode": mode})
        return pick


# ---------------------------------------------------------------------------
# Decision entry points (what plan() and the conv engines call)
# ---------------------------------------------------------------------------


def tuned_block(L: int, Lh: int, batch: int = 1, device=None, tune: Optional[str] = None,
                chunk: Optional[int] = None) -> int:
    """The overlap-save block of a ``(batch, L) ⊛ (Lh,)`` convolution on
    ``device`` under the resolved mode (``off``: the ``OS_FACTOR``
    heuristic); ``chunk`` keys it to a streaming call grain."""
    mode = resolve_mode(tune)
    space = TuningSpace.for_os_block(L, Lh, batch, device, chunk=chunk)
    return int(space.decide(mode)["block"])


def modeled_block(L: int, Lh: int, batch: int = 1, device=None, chunk: Optional[int] = None) -> int:
    """The pure roofline block pick, with no cache and no measurement: a
    function of the shape alone, the same on every rank of a process group.
    :func:`~repro_torch.core.distributed.pconv_os_sharded` and
    ``StreamingConv(spmd=True)`` take it; ``chunk`` keys it to a streaming
    call grain as :func:`tuned_block`'s does."""
    from repro_torch.analysis.roofline import prune_candidates

    space = TuningSpace.for_os_block(L, Lh, batch, device, chunk=chunk)
    return int(prune_candidates(space.candidates, tol=PRUNE_TOL)[0][0]["block"])


def pencil_config(n: int, d: int, batch: int = 1, tune: Optional[str] = None,
                  natural_order: bool = True) -> dict:
    """The distributed pencil FFT's decisions (factors, all-to-all chunk
    count K, packing) for a length-``n`` transform over ``d`` ranks.

    Cache-free and measurement-free: a function of ``(n, d, batch, mode)``
    alone, so every rank derives the same config.  ``"measure"`` clamps to
    the modelled pick; ``"off"`` is the balanced, packed schedule with
    K = 1; ``d ≤ 1`` is the balanced split with nothing to exchange.
    """
    from repro_torch.analysis.roofline import prune_candidates

    mode = resolve_mode(tune)
    if d <= 1:
        from repro_torch.core import distributed as dist  # lazy: distributed plans through here

        n1, n2 = dist.pencil_factors(n, max(d, 1))
        return {"n1": n1, "n2": n2, "pack": True, "a2a_chunks": 1}
    space = TuningSpace.for_pencil(n, d, batch, natural_order)
    if mode == "off":
        return space.candidates[0][0]
    return dict(prune_candidates(space.candidates, tol=PRUNE_TOL)[0][0])


def _pencil_smem_bytes(m: int, axis: int) -> int:
    """The largest per-block shared memory of the table forms a local
    length-``m`` program over ``axis`` runs its column and row passes in
    (0: whole-signal passes only)."""
    from repro_torch.core import plan as plan_lib
    from repro_torch.kernels import ops, pencil

    takes = ops.form_passes(plan_lib.plan_fft(m), axis)
    return max((pencil.form_smem_bytes(pencil.table_form(k, f)) for k, f in takes.values()), default=0)


def plan_config(spec, backend_name: str, tune: Optional[str] = None, device=None,
                budget: Optional[int] = None) -> Optional[dict]:
    """The tuned plan config of ``spec`` on backend ``backend_name`` (None
    for ``off`` and for a backend that runs no forms: the CPU route's
    ``torch``).  ``budget`` as :meth:`TuningSpace.for_plan`'s."""
    mode = resolve_mode(tune)
    if mode == "off" or backend_name != "cuda":
        return None
    return TuningSpace.for_plan(spec, device, budget).decide(mode)
