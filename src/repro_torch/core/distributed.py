"""Distributed pencil FFT over ``torch.distributed``: the paper's hierarchy
one level up.

Port of ``repro/core/distributed.py``.  On one card the paper's schedule
bounds the round trips between HBM and on-chip memory; across cards the slow
tier is the link, and the schedule bounds **all-to-all transposes**.  A
length-N transform over d ranks is factored N = n1 · n2 (both divisible by
d) and runs as::

    a2a-transpose → local FFT(n1) → twiddle → a2a-transpose → local FFT(n2)
    [→ a2a-transpose for natural output order]

Each local FFT is a :class:`~repro_torch.core.fft.PlannedFFT` on the rank's
card: the length-n1 column transform is ``plan(FFTSpec(n1, axis=-2))`` run
in place over the column slab (``cols_pass``), the length-n2 row transform
``plan(FFTSpec(n2))`` (``dft_matmul`` / ``fft4step``).  Each rank builds only
its own window of the twiddle grid, on its card
(:func:`~repro_torch.core.twiddle.twiddle_window`).

The schedule, as the reference's:

* **Packed collectives**: the split-complex pair rides ONE stacked
  all-to-all per transpose: 3 collectives for a natural-order forward
  where the per-plane path (``pack=False``, kept as the baseline) pays 6.
* **Chunk-overlapped transposes**: the two inner all-to-alls are cut into
  K column chunks issued with ``async_op=True``, so chunk i+1's transfer is
  in flight while chunk i's column FFT and twiddle run.  K is a modelled
  decision.
* **Plan layer**: :func:`plan_pencil` resolves factors, K and packing
  (:func:`repro_torch.core.tuning.pencil_config`, modelled only, so every
  rank derives the same schedule) into a cached :class:`PencilPlan`.
* **One rank**: the transform collapses to the local plan with 0
  collectives; ``natural_order=False`` / ``from_pencil=True`` keep the
  k1-major layout through a local four-step.

With ``natural_order=False`` the spectrum stays in pencil layout (global
flat index k1·n2 + k2 holds X[k1 + n1·k2]) and :func:`pifft` with
``from_pencil=True`` consumes it: an fft → pointwise → ifft round trip costs
2K packed all-to-alls instead of the natural path's 2(2K + 1).

Deliberate differences from the reference:

* The functions take the rank's local shard and a ``ProcessGroup``
  (``group=``, default the world; none initialised means one rank), the
  counterpart of a ``shard_map`` body and its ``axis_name``; d and the
  rank come from the group.  ``shard_map_compat`` is JAX's own and is not
  ported.
* :func:`pfft_sharded` / :func:`pifft_sharded` take and return ``DTensor``
  planes sharded on their last dimension over a 1-D ``DeviceMesh`` (the
  counterpart of ``Mesh`` and ``PartitionSpec``).
* :func:`pconv_os_sharded` returns the replicated output through one
  ``all_gather_into_tensor`` of the tails: there is no global array
  outside the group to gather into, as ``shard_map``'s ``out_specs`` give
  the reference.
* Collectives are counted in :data:`COUNTS` (what the tests and the smoke
  read, where the reference counts them in a jaxpr).
* :func:`pfft2d` over one rank runs its two halves with no collective (an
  all-to-all over one rank is a copy).
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core import faults
from repro_torch.core import fft as fft_lib
from repro_torch.core import plan as plan_lib
from repro_torch.core import twiddle as tw
from repro_torch.core.fft_torch import cmul

Planes = Tuple[torch.Tensor, torch.Tensor]

__all__ = [
    "COUNTS",
    "reset_counts",
    "counts",
    "pencil_factors",
    "PencilPlan",
    "plan_pencil",
    "pfft",
    "pifft",
    "pfft2d",
    "pfft_sharded",
    "pifft_sharded",
    "pconv_os_sharded",
]

#: Collectives issued in this process, by kind: one per
#: ``all_to_all_single`` (backward passes included) and one per
#: ``all_gather_into_tensor``.
COUNTS = {"all_to_all": 0, "all_gather": 0}


def reset_counts() -> None:
    """Zero the collective counters."""
    for key in COUNTS:
        COUNTS[key] = 0


def counts() -> dict:
    """Snapshot of the collective counters."""
    return dict(COUNTS)


def _world(group) -> tuple:
    """(d, rank) of ``group``; one rank when no process group is
    initialised and none is given."""
    if group is None and not (dist.is_available() and dist.is_initialized()):
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def _leaf_plan(n: int, inverse: bool, device: str, axis: int = -1) -> fft_lib.PlannedFFT:
    """The interned plan of one local pencil transform: ``axis=-2`` runs the
    length-n1 columns in place over the slab."""
    return fft_lib.plan(fft_lib.FFTSpec(n=n, kind="ifft" if inverse else "fft", axis=axis), device=device)


def pencil_factors(n: int, d: int) -> tuple:
    """Split n = n1 · n2 (powers of two), both divisible by d, near-square."""
    n1, n2 = plan_lib.balanced_split(n)
    while n1 % d and n2 >= d * 2:
        n1 *= 2
        n2 //= 2
    if n1 % d or n2 % d:
        raise faults.PlanError(f"cannot pencil-split n={n} over {d} devices")
    return n1, n2


# ---------------------------------------------------------------------------
# The all-to-all
# ---------------------------------------------------------------------------


def _exchange(x: torch.Tensor, group, split: int, concat: int, async_op: bool) -> Callable:
    """Start one tiled all-to-all of ``x``: dimension ``split`` is cut into d
    chunks, chunk j goes to rank j, and the chunks received are joined
    along ``concat`` in rank order.  Returns the function that waits for
    the transfer and gives the result."""
    d = dist.get_world_size(group)
    split, concat = split % x.ndim, concat % x.ndim
    send = x.unflatten(split, (d, x.shape[split] // d)).movedim(split, 0).contiguous()
    recv = torch.empty_like(send)
    faults.maybe_fail("pencil.all_to_all", split_axis=split, concat_axis=concat)
    COUNTS["all_to_all"] += 1
    work = dist.all_to_all_single(recv, send, group=group, async_op=async_op)

    def finish(_send=send) -> torch.Tensor:
        # The default argument holds the send buffer until the transfer is
        # done: an asynchronous collective must not see it freed and reused.
        if work is not None:
            work.wait()
        return recv.movedim(0, concat).flatten(concat, concat + 1)

    return finish


class _A2A(torch.autograd.Function):
    """The all-to-all as an autograd leaf: a permutation across ranks, whose
    adjoint is the reverse all-to-all (``split`` and ``concat`` swapped)."""

    @staticmethod
    def forward(ctx, x, group, split: int, concat: int):
        ctx.group, ctx.split, ctx.concat = group, split, concat
        return _exchange(x, group, split, concat, False)()

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group, ctx.concat, ctx.split, False)(), None, None, None


def _a2a(x: torch.Tensor, group, split: int, concat: int, *, async_op: bool = False) -> Callable:
    """One all-to-all (see :func:`_exchange`); returns the function that
    gives its result.  An input that needs a gradient goes through the
    synchronous autograd leaf."""
    if torch.is_grad_enabled() and x.requires_grad:
        y = _A2A.apply(x, group, split, concat)
        return lambda: y
    return _exchange(x, group, split, concat, async_op)


def _pack2(xr, xi) -> torch.Tensor:
    return torch.stack([xr, xi])


# ---------------------------------------------------------------------------
# Plan layer: PencilPlan / plan_pencil
# ---------------------------------------------------------------------------


class PencilPlan:
    """The frozen schedule of one distributed pencil transform.

    Factors, packing, the chunk count and the local plans are resolved once
    (through :func:`repro_torch.core.tuning.pencil_config`, modelled only,
    so every rank derives the same schedule) and reused by every call of
    the same shape.  ``describe()`` prints the schedule with its modelled
    communication beside it (:func:`~repro_torch.analysis.roofline.pencil_report`).
    """

    def __init__(self, n: int, d: int, *, inverse: bool, device: str, config: dict,
                 natural_order: bool = True):
        from repro_torch.analysis import roofline as rl  # lazy: analysis plans through here

        self.n, self.d, self.inverse, self.device = n, d, inverse, device
        self.n1, self.n2 = int(config["n1"]), int(config["n2"])
        if self.n1 * self.n2 != n:
            raise faults.PlanError(f"pencil factors {self.n1}x{self.n2} != n={n}")
        if d > 1 and (self.n1 % d or self.n2 % d):
            raise faults.PlanError(f"pencil factors {self.n1}x{self.n2} not divisible by d={d}")
        self.p = self.n1 // max(d, 1)
        self.q = self.n2 // max(d, 1)
        self.pack = bool(config.get("pack", True))
        k = int(config.get("a2a_chunks", 1))
        # K must divide the rank's column count: clamp a foreign or
        # hand-written config rather than fail the transform.
        while k > 1 and (k > self.q or self.q % k):
            k //= 2
        self.a2a_chunks = k if self.pack else 1
        self.tuned = dict(config)
        self.plan_n1 = _leaf_plan(self.n1, inverse, device, axis=-2)
        self.plan_n2 = _leaf_plan(self.n2, inverse, device)
        #: One rank in natural order: the single-card program.
        self.local_plan = _leaf_plan(n, inverse, device) if d <= 1 else None
        self.report = rl.pencil_report(n, d, n1=self.n1, n2=self.n2, pack=self.pack,
                                       chunks=self.a2a_chunks, natural_order=natural_order)

    def a2a_count(self, natural_order: bool = True) -> int:
        """Collectives one transform issues."""
        if self.d <= 1:
            return 0
        if self.pack:
            return 2 * self.a2a_chunks + (1 if natural_order else 0)
        return 2 * (3 if natural_order else 2)

    def describe(self) -> str:
        kind = "pifft" if self.inverse else "pfft"
        mb = self.report["comm_bytes_per_step"] / 2**20
        local_mb = self.report["local_hbm_bytes"] / 2**20
        head = f"{kind} N={self.n} over d={self.d}: factors {self.n1}x{self.n2} (p={self.p}, q={self.q}); "
        if self.d <= 1:
            sched = "collapses to the local plan, 0 collectives"
        else:
            sched = (
                f"{'packed' if self.pack else 'split-plane'} a2a x{self.a2a_count(True)} natural / "
                f"x{self.a2a_count(False)} pencil (K={self.a2a_chunks}); comm {mb:.2f} MB/step"
            )
        lines = [head + sched + f"; local HBM {local_mb:.2f} MB"]
        if self.local_plan is not None:
            lines.append(f"  local: {self.local_plan.describe()}")
        lines.append(f"  leaf n1: {self.plan_n1.describe()}")
        lines.append(f"  leaf n2: {self.plan_n2.describe()}")
        return "\n".join(lines)

    def __repr__(self):
        return (f"PencilPlan(n={self.n}, d={self.d}, {self.n1}x{self.n2}, pack={self.pack}, "
                f"K={self.a2a_chunks}, device={self.device!r})")


@functools.lru_cache(maxsize=256)
def _pencil_plan_cached(n: int, d: int, inverse: bool, device: str, mode: str, factors: Optional[tuple],
                        pack: Optional[bool], chunks: Optional[int], natural_order: bool) -> PencilPlan:
    from repro_torch.core import tuning  # lazy: tuning plans through here

    config = dict(tuning.pencil_config(n, d, tune=mode, natural_order=natural_order))
    if factors is not None:
        config["n1"], config["n2"] = factors
    if pack is not None:
        config["pack"] = pack
    if chunks is not None:
        config["a2a_chunks"] = chunks
    return PencilPlan(n, d, inverse=inverse, device=device, config=config, natural_order=natural_order)


def plan_pencil(n: int, num_shards: int, *, inverse: bool = False, device=None, tune: Optional[str] = None,
                factors: Optional[tuple] = None, pack: Optional[bool] = None, chunks: Optional[int] = None,
                natural_order: bool = True) -> PencilPlan:
    """Resolve a distributed pencil transform into a cached :class:`PencilPlan`.

    ``device`` is where the local plans run (None: the card; raises without
    one).  ``tune`` picks how the knobs are chosen: ``"off"`` the balanced,
    packed K = 1 schedule, ``"model"`` (the default) the modelled pick;
    both are functions of the shape alone, and ``"measure"`` clamps to the
    modelled pick.  ``factors`` / ``pack`` / ``chunks`` override single
    decisions (every rank must pass the same values).
    """
    from repro_torch.core import tuning  # lazy: tuning plans through here

    return _pencil_plan_cached(
        int(n), int(num_shards), bool(inverse), str(fft_lib._resolve_device(device)), tuning.resolve_mode(tune),
        tuple(factors) if factors is not None else None, pack, chunks, bool(natural_order),
    )


def _resolve(xr, n: Optional[int], group, *, inverse: bool, tune, factors, pack, chunks, natural_order,
             pplan: Optional[PencilPlan]) -> tuple:
    """(plan, d, rank) of one call on the local shard ``xr``."""
    d, rank = _world(group)
    local = xr.shape[-1]
    n = local * d if n is None else n
    if local * d != n:
        raise faults.PlanError(f"a local shard of {local} over {d} ranks is not n={n}")
    pl = pplan or plan_pencil(n, d, inverse=inverse, device=xr.device, tune=tune, factors=factors, pack=pack,
                              chunks=chunks, natural_order=natural_order)
    if (pl.n, pl.d) != (n, d):
        raise faults.PlanError(f"{pl!r} is not a plan for n={n} over d={d}")
    return pl, d, rank


# ---------------------------------------------------------------------------
# The overlapped middle: a2a in → column compute → a2a out, K chunks
# ---------------------------------------------------------------------------


def _middle_pipelined(z: torch.Tensor, *, group, d: int, rank: int, q: int, k: int,
                      compute: Callable) -> torch.Tensor:
    """The middle of the schedule on the packed (2, ..., p, n2) stack:
    transpose to column slabs, run ``compute`` on each column chunk,
    transpose back, cut into ``k`` chunks of q/k columns per rank.  Chunk
    c+1's all-to-all is issued (``async_op=True``) before chunk c's compute
    runs, so the transfer overlaps the column FFT; the return transfers are
    issued as each chunk finishes and awaited at the end.

    ``compute(chunk, col_start, width)`` maps a (2, ..., n1, width) column
    chunk (``col_start`` the global column offset of this rank's window) to
    its transformed chunk of the same shape.
    """
    lead = z.shape[:-1]  # (2, *batch, p)
    qk = q // k
    zs = z.reshape(*lead, d, q)

    def send(c):
        # Columns j·q + c·qk … j·q + (c+1)·qk for every destination j: the
        # slices whose all-to-all lands as chunk c's (n1, qk) slab on rank j.
        return _a2a(zs[..., c * qk:(c + 1) * qk].reshape(*lead, d * qk), group, -1, -2, async_op=True)

    recv = send(0)
    outs = []
    for c in range(k):
        nxt = send(c + 1) if c + 1 < k else None  # the next transfer in flight
        y = compute(recv(), rank * q + c * qk, qk)
        outs.append(_a2a(y, group, -2, -1, async_op=True))  # back to row slabs
        recv = nxt
    chunks = [o().reshape(*lead, d, qk) for o in outs]
    return torch.stack(chunks, dim=-2).reshape(*lead, d * q)  # (..., p, d, k, qk): chunk-major columns


# ---------------------------------------------------------------------------
# pfft / pifft
# ---------------------------------------------------------------------------


def pfft(xr: torch.Tensor, xi: torch.Tensor, *, n: Optional[int] = None, group=None, inverse: bool = False,
         natural_order: bool = True, tune: Optional[str] = None, pack: Optional[bool] = None,
         chunks: Optional[int] = None, factors: Optional[tuple] = None,
         pplan: Optional[PencilPlan] = None) -> Planes:
    """Distributed FFT over the last axis of a block-sharded signal.

    ``xr``/``xi``: this rank's contiguous shard (..., n / d) of the
    length-``n`` signal (default ``n``: the shard's length times d), split
    float32 planes on the rank's device.  Returns this rank's shard of the
    output; with ``natural_order=False`` in pencil layout (global flat index
    k1·n2 + k2 holds X[k1 + n1·k2]).  Every rank of ``group`` must call with
    the same shapes and options.  The schedule comes from
    :func:`plan_pencil` (``pplan`` reuses a handle; ``pack`` / ``chunks`` /
    ``factors`` override one decision).  One rank collapses to the local
    plan: no collective.
    """
    pl, d, rank = _resolve(xr, n, group, inverse=inverse, tune=tune, factors=factors, pack=pack,
                           chunks=chunks, natural_order=natural_order, pplan=pplan)
    n1, n2, p, q = pl.n1, pl.n2, pl.p, pl.q
    lead = xr.shape[:-1]

    if d <= 1:
        if natural_order:
            return pl.local_plan.apply_planes(xr, xi)
        # A local four-step in pencil layout: the k1-major semantics of
        # natural_order=False, with no collective.
        xr, xi = pl.plan_n1.apply_planes(xr.reshape(*lead, n1, n2), xi.reshape(*lead, n1, n2))
        xr, xi = cmul(xr, xi, *tw.twiddle_window(n1, n2, inverse, device=xr.device))
        xr, xi = pl.plan_n2.apply_planes(xr, xi)
        return xr.reshape(*lead, pl.n), xi.reshape(*lead, pl.n)

    # The local shard is rows [rank·p, (rank+1)·p) of the (n1, n2) matrix.
    xr = xr.reshape(*lead, p, n2)
    xi = xi.reshape(*lead, p, n2)
    if not pl.pack:
        return _pfft_unpacked(xr, xi, pl, group=group, rank=rank, inverse=inverse,
                              natural_order=natural_order, lead=lead)

    def col_chunk(chunk, col_start, width):
        cr, ci = pl.plan_n1.apply_planes(chunk[0], chunk[1])
        cr, ci = cmul(cr, ci, *tw.twiddle_window(n1, n2, inverse, col_start=col_start, col_count=width,
                                                 device=cr.device))
        return _pack2(cr, ci)

    z = _middle_pipelined(_pack2(xr, xi), group=group, d=d, rank=rank, q=q, k=pl.a2a_chunks,
                          compute=col_chunk)
    # Full rows again, (2, ..., p, n2): the FFT over n2 is local.  (Inverse:
    # the two leaf transforms contribute 1/n1 · 1/n2 = 1/n.)
    zr, zi = pl.plan_n2.apply_planes(z[0], z[1])
    if not natural_order:
        return zr.reshape(*lead, p * n2), zi.reshape(*lead, p * n2)
    # The reorder to natural order: C (p, n2) → the C^T slab (n2/d, n1),
    # one packed collective with no chunk overlap.
    z = _a2a(_pack2(zr, zi), group, -1, -2)().transpose(-1, -2)
    q2 = n2 // d
    return z[0].reshape(*lead, q2 * n1), z[1].reshape(*lead, q2 * n1)


def _pfft_unpacked(xr, xi, pl: PencilPlan, *, group, rank, inverse, natural_order, lead) -> Planes:
    """The per-plane serial schedule (two collectives per transpose, no
    chunk overlap): the baseline the packed path is measured against."""
    n1, n2, p, q = pl.n1, pl.n2, pl.p, pl.q
    xr, xi = _a2a(xr, group, -1, -2)(), _a2a(xi, group, -1, -2)()
    xr, xi = pl.plan_n1.apply_planes(xr, xi)
    xr, xi = cmul(xr, xi, *tw.twiddle_window(n1, n2, inverse, col_start=rank * q, col_count=q,
                                             device=xr.device))
    xr, xi = _a2a(xr, group, -2, -1)(), _a2a(xi, group, -2, -1)()
    xr, xi = pl.plan_n2.apply_planes(xr, xi)
    if not natural_order:
        return xr.reshape(*lead, p * n2), xi.reshape(*lead, p * n2)
    xr, xi = _a2a(xr, group, -1, -2)(), _a2a(xi, group, -1, -2)()
    q2 = n2 // pl.d
    return xr.transpose(-1, -2).reshape(*lead, q2 * n1), xi.transpose(-1, -2).reshape(*lead, q2 * n1)


def pifft(xr: torch.Tensor, xi: torch.Tensor, *, n: Optional[int] = None, group=None,
          from_pencil: bool = False, tune: Optional[str] = None, pack: Optional[bool] = None,
          chunks: Optional[int] = None, factors: Optional[tuple] = None,
          pplan: Optional[PencilPlan] = None) -> Planes:
    """Distributed inverse FFT (see :func:`pfft`).

    With ``from_pencil=True`` it consumes the k1-major layout of
    ``pfft(..., natural_order=False)`` through the mirrored schedule, with
    no reordering collective.  Packing and chunk overlap mirror :func:`pfft`.
    """
    pl, d, rank = _resolve(xr, n, group, inverse=True, tune=tune, factors=factors, pack=pack, chunks=chunks,
                           natural_order=not from_pencil, pplan=pplan)
    n1, n2, p, q = pl.n1, pl.n2, pl.p, pl.q
    lead = xr.shape[:-1]

    if d <= 1:
        if not from_pencil:
            return pl.local_plan.apply_planes(xr, xi)
        # The mirror of the one-rank pencil-layout forward.
        xr, xi = pl.plan_n2.apply_planes(xr.reshape(*lead, n1, n2), xi.reshape(*lead, n1, n2))
        xr, xi = cmul(xr, xi, *tw.twiddle_window(n1, n2, True, device=xr.device))
        xr, xi = pl.plan_n1.apply_planes(xr, xi)
        return xr.reshape(*lead, pl.n), xi.reshape(*lead, pl.n)

    if not pl.pack:
        return _pifft_unpacked(xr, xi, pl, group=group, rank=rank, from_pencil=from_pencil, lead=lead)

    if not from_pencil:
        # Natural order: the rank holds C^T rows (q, n1); one packed
        # collective back to pencil layout.
        z = _a2a(_pack2(xr.reshape(*lead, q, n1), xi.reshape(*lead, q, n1)), group, -1, -2)()
        zr, zi = z[0].transpose(-1, -2), z[1].transpose(-1, -2)  # (..., p, n2)
    else:
        zr, zi = xr.reshape(*lead, p, n2), xi.reshape(*lead, p, n2)
    # The mirror of pfft: the inverse FFT over n2 (rows, local) first.
    zr, zi = pl.plan_n2.apply_planes(zr, zi)

    def col_chunk(chunk, col_start, width):
        cr, ci = cmul(chunk[0], chunk[1], *tw.twiddle_window(n1, n2, True, col_start=col_start,
                                                             col_count=width, device=chunk.device))
        return _pack2(*pl.plan_n1.apply_planes(cr, ci))

    z = _middle_pipelined(_pack2(zr, zi), group=group, d=d, rank=rank, q=q, k=pl.a2a_chunks,
                          compute=col_chunk)
    return z[0].reshape(*lead, p * n2), z[1].reshape(*lead, p * n2)


def _pifft_unpacked(xr, xi, pl: PencilPlan, *, group, rank, from_pencil, lead) -> Planes:
    """The per-plane inverse schedule (the baseline)."""
    n1, n2, p, q = pl.n1, pl.n2, pl.p, pl.q
    if not from_pencil:
        xr, xi = xr.reshape(*lead, q, n1), xi.reshape(*lead, q, n1)
        xr, xi = _a2a(xr, group, -1, -2)(), _a2a(xi, group, -1, -2)()
        xr, xi = xr.transpose(-1, -2), xi.transpose(-1, -2)
    else:
        xr, xi = xr.reshape(*lead, p, n2), xi.reshape(*lead, p, n2)
    xr, xi = pl.plan_n2.apply_planes(xr, xi)
    xr, xi = _a2a(xr, group, -1, -2)(), _a2a(xi, group, -1, -2)()
    xr, xi = cmul(xr, xi, *tw.twiddle_window(n1, n2, True, col_start=rank * q, col_count=q, device=xr.device))
    xr, xi = pl.plan_n1.apply_planes(xr, xi)
    xr, xi = _a2a(xr, group, -2, -1)(), _a2a(xi, group, -2, -1)()
    return xr.reshape(*lead, p * n2), xi.reshape(*lead, p * n2)


# ---------------------------------------------------------------------------
# 2-D
# ---------------------------------------------------------------------------


def pfft2d(xr: torch.Tensor, xi: torch.Tensor, *, n1: int, n2: int, group=None, inverse: bool = False,
           pack: bool = True) -> Planes:
    """Distributed 2-D FFT (SAR range / azimuth): rows local, columns pencil.

    ``xr``/``xi``: this rank's (..., n1 / d, n2) rows of an (n1, n2) image.
    One joint 2-D plan (``FFTSpec(n2, kind="fft2", n2=n1)``, the program the
    single-card path runs) is split around the collectives: its row passes
    on the row slab (:meth:`~repro_torch.core.fft.PlannedFFT.apply_rows`),
    one packed all-to-all to (n1, n2 / d) column slabs, its column passes in
    place (:meth:`~repro_torch.core.fft.PlannedFFT.apply_cols`), and one
    back: 2 collectives, 4 with ``pack=False``.  One rank runs the two
    halves with none.
    """
    d, _rank = _world(group)
    if xr.ndim < 2 or xr.shape[-2] * d != n1 or xr.shape[-1] != n2:
        raise faults.PlanError(f"pfft2d over {d} ranks takes (..., {n1} / {d}, {n2}) rows, "
                               f"got {tuple(xr.shape)}")
    joint = fft_lib.plan(fft_lib.FFTSpec(n=n2, kind="ifft2" if inverse else "fft2", n2=n1), device=xr.device)
    xr, xi = joint.apply_rows(xr, xi)
    if d <= 1:
        return joint.apply_cols(xr, xi)
    if pack:
        z = _a2a(_pack2(xr, xi), group, -1, -2)()  # (2, ..., n1, n2 / d) column slabs
        z = _a2a(_pack2(*joint.apply_cols(z[0], z[1])), group, -2, -1)()  # back to row slabs
        return z[0], z[1]
    xr, xi = _a2a(xr, group, -1, -2)(), _a2a(xi, group, -1, -2)()
    xr, xi = joint.apply_cols(xr, xi)
    return _a2a(xr, group, -2, -1)(), _a2a(xi, group, -2, -1)()


# ---------------------------------------------------------------------------
# DTensor wrappers
# ---------------------------------------------------------------------------


def _sharded(fn, xr, xi, **kw):
    """Run ``fn`` on the local shards of DTensor planes sharded on their
    last dimension over a 1-D mesh; wrap its output with the same mesh and
    placement."""
    from torch.distributed.tensor import DTensor, Shard  # lazy: DTensor loads its own machinery

    for t in (xr, xi):
        if not isinstance(t, DTensor):
            raise faults.PlanError(f"expected DTensor planes, got {type(t).__name__}")
        place = t.placements
        if t.device_mesh.ndim != 1 or len(place) != 1 or not isinstance(place[0], Shard) \
                or place[0].dim % t.ndim != t.ndim - 1:
            raise faults.PlanError(f"planes must be sharded on their last dimension over a 1-D mesh, got "
                                   f"{place} over a {t.device_mesh.ndim}-D mesh")
    mesh = xr.device_mesh
    yr, yi = fn(xr.to_local(), xi.to_local(), n=xr.shape[-1], group=mesh.get_group(0), **kw)
    wrap = functools.partial(DTensor.from_local, device_mesh=mesh, placements=xr.placements,
                             shape=xr.shape, stride=xr.stride())
    return wrap(yr), wrap(yi)


def pfft_sharded(xr, xi, *, inverse: bool = False, natural_order: bool = True, tune: Optional[str] = None,
                 pack: Optional[bool] = None, chunks: Optional[int] = None, factors: Optional[tuple] = None):
    """:func:`pfft` of ``DTensor`` planes sharded on their last dimension
    over a 1-D ``DeviceMesh``; returns ``DTensor`` planes with the same
    mesh and placement."""
    return _sharded(pfft, xr, xi, inverse=inverse, natural_order=natural_order, tune=tune, pack=pack,
                    chunks=chunks, factors=factors)


def pifft_sharded(xr, xi, *, from_pencil: bool = False, tune: Optional[str] = None, pack: Optional[bool] = None,
                  chunks: Optional[int] = None, factors: Optional[tuple] = None):
    """:func:`pifft` of ``DTensor`` planes (see :func:`pfft_sharded`)."""
    return _sharded(pifft, xr, xi, from_pencil=from_pencil, tune=tune, pack=pack, chunks=chunks,
                    factors=factors)


# ---------------------------------------------------------------------------
# Overlap-save convolution over the group
# ---------------------------------------------------------------------------


def pconv_os_sharded(x, h, *, group=None, causal: bool = True, block: Optional[int] = None, device=None,
                     tune: Optional[str] = None, chunk_hint: Optional[int] = None) -> torch.Tensor:
    """Distributed overlap-save convolution: the blocks shared out over the
    group.

    The blocks of :func:`repro_torch.core.overlap.fft_conv_os` are
    independent (each carries its own ``Lh − 1`` history in its frame), so
    each rank convolves its own run of blocks with no all-to-all.  ``x``:
    the (..., L) signal, the same on every rank; ``h`` broadcasts as in
    ``fft_conv``.  The block count is padded to a multiple of d with zero
    frames (their outputs fall past ``L_out`` and are cut).  Returns the
    (..., L) causal output (L + Lh − 1 with ``causal=False``) on every rank,
    gathered by one ``all_gather_into_tensor`` of the tails.

    With ``block=None`` and ``tune`` not ``"off"`` the block is
    :func:`~repro_torch.core.tuning.modeled_block`'s: no cache, no
    measurement, the same on every rank; ``chunk_hint`` keys it to a
    streaming call grain.  Pass a block measured elsewhere as ``block=``.
    """
    from repro_torch.core import overlap as ov  # lazy: overlap loads after this module
    from repro_torch.core import tuning
    from repro_torch.core.conv import as_filter, as_signal, resolve_device

    d, rank = _world(group)
    dev = resolve_device(x, device)
    x = as_signal(x, dev)
    out_dtype = x.dtype
    x = x.to(torch.float32)
    h = as_filter(h, dev)
    L, Lh = x.shape[-1], h.shape[-1]
    batch = math.prod(x.shape[:-1])
    if block is not None:
        B = ov.pick_block(Lh, block)
    elif tuning.resolve_mode(tune) == "off" or Lh < 2:
        B = ov.pick_block(Lh)
    else:
        B = tuning.modeled_block(L, Lh, batch, dev, chunk=chunk_hint)
    overlap = Lh - 1
    step = B - overlap
    L_out = L if causal else L + Lh - 1
    nb = -(-L_out // step)
    nb = -(-nb // d) * d  # whole blocks per rank; the extras are zero frames
    mine = nb // d
    frames = ov.frame_signal(x, B, step, nb)[..., rank * mine:(rank + 1) * mine, :]
    Hr, Hi = ov.filter_spectrum(h, B, dev)  # computed on every rank
    tails = ov.conv_frames(frames, Hr, Hi, overlap=overlap)  # (..., mine, step)
    lead = tails.shape[:-2]
    if d > 1:
        out = tails.new_empty(d * tails.numel())
        COUNTS["all_gather"] += 1
        dist.all_gather_into_tensor(out, tails.reshape(-1), group=group)
        tails = out.view(d, *tails.shape).movedim(0, -3)  # (..., d, mine, step): rank-major blocks
    y = tails.reshape(*lead, nb * step)[..., :L_out]
    return y.to(out_dtype)
