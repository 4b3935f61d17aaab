"""FFT execution planning — the paper's kernel-call schedule.

Port of ``repro/core/plan.py``, whole: it is pure metadata and must emit the
reference's pass program pass for pass (``tests/test_torch_plan.py``
holds it to that).  The schedule:

* ``direct``   — N ≤ DIRECT_MAX: one kernel call, a single DFT matmul.
* ``fused4``   — N ≤ FUSED_MAX: one kernel call running Bailey's four-step
  ``(W_{N1}·X ⊙ T)·W_{N2}`` → **one** HBM round trip.
* ``split``    — larger N: factor N = f₀ · f₁ · … (each factor in the fused
  regime) and execute a **linearized pass program**: one HBM round trip per
  factor.

The split regime is compiled down to :attr:`FFTPlan.passes`, an ordered list
of :class:`Pass` records in which all glue is fused into the kernels: each
pass carries its input/output pencil views ``(pencils, stride, n)``, the
inter-factor twiddle it applies in its epilogue (``twiddle_after``), and the
buffer ``order`` it leaves behind.  The executor
(``repro_torch.kernels.ops.execute_program``) walks this list launching
exactly ``len(passes)`` kernels.

Pencil view convention: per batch row, the flat length-N buffer decomposes
into ``pencils`` signals of length ``n``; pencil ``p`` occupies flat offsets
``off(p) + stride·t`` for ``t ∈ [0, n)`` with
``off(p) = (p // stride)·(stride·n) + (p % stride)``.  ``stride == 1`` is
contiguous rows; ``stride == pencils`` is the interleaved-column view of the
first factor.  The natural-order output of a two-factor program is itself a
column view — which is why the final reorder folds into the last kernel's
strided write instead of costing an HBM transpose.

The reference's "VMEM" models (:func:`vmem_bytes`, :func:`pick_batch_tile`,
:func:`pick_pass_chunk`) are kept verbatim so the port plans what the
reference plans; the CUDA kernels choose their own launch geometry and do
not read them.
"""

from __future__ import annotations

import dataclasses
import functools
import math

from repro_torch.core import faults
from repro_torch.core.limits import (
    DIRECT_MAX,
    FUSED_MAX,
    VMEM_BUDGET,
    bluestein_pad,
    memory_budget,
)

__all__ = [
    "DIRECT_MAX",
    "FUSED_MAX",
    "VMEM_BUDGET",
    "FFTPlan",
    "Pass",
    "plan_fft",
    "plan_fft2",
    "compile_passes",
    "compile_passes2d",
    "compile_bluestein",
    "joint2d_supported",
    "program_factors",
    "balanced_split",
    "vmem_bytes",
    "pass_hbm_bytes",
    "pass_other",
    "program_hbm_bytes",
    "pick_pass_chunk",
    "describe",
    "describe_program",
    "plan_from_records",
    "pass_record",
]

# DIRECT_MAX / FUSED_MAX / VMEM_BUDGET are defined in core/limits.py (the
# single source for every regime threshold) and re-exported here because the
# planner is where the rest of the codebase historically imported them from.


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def balanced_split(n: int, cap: int | None = None) -> tuple[int, int]:
    """Split n = n1 * n2, powers of two, as square as possible, n1 >= n2.

    If ``cap`` is given, n2 is forced ≤ cap (used by the recursive splitter so
    the inner factor always lands in the fused-kernel regime).
    """
    if not _is_pow2(n):
        raise faults.PlanError(f"FFT length must be a power of two, got {n}")
    lg = n.bit_length() - 1
    lg1 = (lg + 1) // 2
    n1, n2 = 1 << lg1, 1 << (lg - lg1)
    if cap is not None:
        while n2 > cap:
            n2 //= 2
            n1 *= 2
    return n1, n2


@dataclasses.dataclass(frozen=True)
class Pass:
    """One HBM round trip of the linearized pass program.

    kind: 'direct' | 'fused4' — the on-chip algorithm of the single
          kernel call — or 'reorder', the digit-reversal relayout pass that
          only programs with ≥ 3 factors (N > 2³²) need for natural order.
    n:    per-pencil transform length handled by this pass.
    n1/n2: four-step factors (fused4 only; n1*n2 == n).
    view_in / view_out:
          ``(pencils, stride, n)`` pencil views of the flat per-row buffer
          (module docstring has the offset convention).  ``view_out`` differs
          from ``view_in`` exactly when the natural-order transpose is fused
          into this pass's strided write.
    twiddle_after:
          ``(n_bins, n_phases)`` — after transforming, bin ``k`` of pencil
          ``p`` is multiplied by ``W_{n_bins·n_phases}^{k·(p % n_phases)}``
          in the kernel's epilogue (None for the last pass).  The grid is
          a host-built LUT, device-resident, streamed once per pass.
    order: buffer ordering this pass leaves behind: 'natural' | 'pencil'.
    axis:  transform axis of a multi-axis (2-D image) program: ``-1`` for
          row passes over the contiguous last axis, ``-2`` for in-place
          strided-column passes down the image's second-to-last axis (views
          are relative to that axis's length; the image width rides along as
          extra pencil columns of the strided kernel).
    """

    kind: str
    n: int
    n1: int = 0
    n2: int = 0
    view_in: tuple = ()
    view_out: tuple = ()
    twiddle_after: tuple | None = None
    order: str = "pencil"
    axis: int = -1
    #: Bluestein chirp-conv leaves only: which piece of the chirp pipeline
    #: this pass executes.  Fused regime: ``"fwd"`` (chirp-pre + zero-pad +
    #: pad-length FFT + ⊙B̂, one call) then ``"inv"`` (pad-length IFFT +
    #: slice + chirp-post, one call).  Split regime (pad > FUSED_MAX):
    #: ``"pre"`` / ``"mul"`` / ``"post"`` elementwise chirp passes
    #: sandwiching the pad length's own compiled pow2 program.  For a
    #: bluestein pass ``n`` is the logical transform length and ``n1`` the
    #: conv pad length M.
    stage: str = ""
    #: Transform-direction override for the passes INSIDE a Bluestein conv:
    #: the inner pad-length FFT/IFFT pair always runs forward-then-inverse
    #: regardless of the outer transform's direction (which only flips the
    #: chirp LUTs).  ``None`` — every non-Bluestein program — defers to the
    #: executor's program-level ``inverse`` flag.
    inverse: bool | None = None


@dataclasses.dataclass(frozen=True)
class FFTPlan:
    """Factorisation of a length-``n`` transform into HBM round trips.

    ``passes`` is the compiled, ordered natural-order pass program — the
    HBM round-trip sequence the executor literally issues.  ``levels`` /
    ``leaf_passes`` remain as the recursion-shaped metadata the pure-XLA
    backend and the LUT warm-up still consume.  ``hbm_round_trips`` is the
    figure the paper tabulates as "number of kernel calls".

    ``n2`` marks a multi-axis program: the plan transforms an
    ``(..., n2, n)`` image and ``passes`` mixes ``axis=-1`` row passes with
    ``axis=-2`` column passes (see :func:`compile_passes2d`).
    """

    n: int
    levels: tuple[tuple[int, int], ...]  # ((n_outer, n_inner), ...) recursion
    leaf_passes: tuple[Pass, ...]        # one leaf pass per distinct length
    passes: tuple[Pass, ...] = ()        # linearized natural-order program
    n2: int | None = None                # second-to-last-axis length (2-D)

    @property
    def hbm_round_trips(self) -> int:
        # One HBM round trip per program pass.  Two factors cover every
        # N ≤ 2³² in two trips — one fewer than the paper's 3-call regime,
        # because the inter-factor twiddle and the natural-order transpose
        # are fused into the kernels instead of being standalone passes.
        return len(self.passes)

    @property
    def kernel_calls(self) -> int:
        """Paper Table-1 terminology: number of distinct kernel launches."""
        return self.hbm_round_trips

    def level_for(self, m: int) -> tuple[int, int] | None:
        """The (n_outer, n_inner) split for a length-``m`` sub-transform, or
        None when ``m`` is a leaf.  Split products are strictly decreasing
        (n, outer0, outer1, ...) so the lookup is unambiguous."""
        for n_outer, n_inner in self.levels:
            if n_outer * n_inner == m:
                return n_outer, n_inner
        return None

    def leaf_pass(self, m: int) -> Pass:
        """The leaf :class:`Pass` executing a length-``m`` sub-transform."""
        for p in self.leaf_passes:
            if p.n == m:
                return p
        raise KeyError(f"length {m} is not a leaf of the plan for n={self.n}")


def _leaf_pass(n: int, direct_max: int = DIRECT_MAX) -> Pass:
    """The leaf engine decision: a direct DFT matmul up to ``direct_max``
    (one GEMM, but an n² LUT), the fused four-step beyond (two √n-sized
    GEMMs + twiddle).  ``direct_max`` is the tuner's engine knob — lowering
    it trades the big DFT matrix stream for four-step arithmetic on leaves
    near the boundary.  Lengths below 8 stay direct (a four-step split
    would degenerate)."""
    if n <= max(direct_max, 8):
        return Pass(kind="direct", n=n)
    n1, n2 = balanced_split(n)
    return Pass(kind="fused4", n=n, n1=n1, n2=n2)


def program_factors(n: int, fused_max: int = FUSED_MAX) -> tuple[int, ...]:
    """Factorize n = f₀ · f₁ · … (outer first), every factor ≤ ``fused_max``.

    This is the recursion of the level tree flattened: the same splits, in
    execution order, so the linearized program and the legacy level metadata
    always agree on the factorisation policy.
    """
    if not _is_pow2(n):
        raise faults.PlanError(f"FFT length must be a power of two, got {n}")
    fs: list[int] = []
    m = n
    while m > fused_max:
        n_outer, n_inner = balanced_split(m, cap=fused_max)
        fs.append(n_inner)
        m = n_outer
    fs.append(m)
    fs.reverse()
    return tuple(fs)


@functools.lru_cache(maxsize=512)
def compile_passes(
    n: int,
    fused_max: int = FUSED_MAX,
    order: str = "natural",
    direct_max: int = DIRECT_MAX,
) -> tuple[Pass, ...]:
    """Compile the ordered pass program for a length-``n`` transform.

    One pass per factor.  Pass ``i`` transforms factor ``fᵢ`` over pencils of
    stride ``sᵢ = ∏_{k>i} f_k`` and applies the inter-factor twiddle
    ``W^{kᵢ·(p % sᵢ)}`` as its VMEM epilogue.  With two factors the final
    natural-order transpose is fused into the last pass's strided write
    (its ``view_out`` is the column view of the output buffer); with three
    or more factors (N > 2³²) natural order needs one explicit ``reorder``
    pass, and ``order='pencil'`` skips it for fft→pointwise→ifft pipelines.
    """
    if order not in ("natural", "pencil"):
        raise faults.PlanError(f"order must be 'natural' or 'pencil', got {order!r}")
    if not _is_pow2(n):
        # Non-pow2 lengths compile to the Bluestein chirp-conv program —
        # natural-order by construction (the post-chirp slice IS the
        # output), so the ``order`` request is moot.
        return compile_bluestein(n, None, fused_max, direct_max)
    fs = program_factors(n, fused_max)
    last = len(fs) - 1
    passes: list[Pass] = []
    stride = n
    for i, f in enumerate(fs):
        stride //= f
        leaf = _leaf_pass(f, direct_max)
        view_in = (n // f, stride, f)
        view_out = view_in
        pass_order = "pencil"
        if i == last:
            if order == "natural" and last == 1:
                # Fused natural-order write: out pencil k₀ at offset k₀,
                # stride f₀ — the column view of the output buffer.
                view_out = (fs[0], fs[0], f)
                pass_order = "natural"
            elif last == 0:
                # Single-factor program: the kernel orders internally and
                # program-level pencil layout degenerates to natural.
                pass_order = "natural"
        passes.append(
            Pass(
                kind=leaf.kind,
                n=f,
                n1=leaf.n1,
                n2=leaf.n2,
                view_in=view_in,
                view_out=view_out,
                twiddle_after=None if i == last else (f, stride),
                order=pass_order,
            )
        )
    if order == "natural" and last >= 2:
        # Digit-reversal relayout: only N > FUSED_MAX² programs pay it.
        flat = (1, 1, n)
        passes.append(
            Pass(kind="reorder", n=n, view_in=flat, view_out=flat, order="natural")
        )
    return tuple(passes)


@functools.lru_cache(maxsize=256)
def compile_bluestein(
    n: int,
    pad: int | None = None,
    fused_max: int = FUSED_MAX,
    direct_max: int = DIRECT_MAX,
) -> tuple[Pass, ...]:
    """Compile the Bluestein chirp-conv pass program for a non-pow2 ``n``.

    The transform is one circular convolution at pad length
    ``M = next_pow2(2n−1)`` (or a caller/tuner-chosen larger pow2 ``pad``)
    between the chirp-modulated signal and the conjugate chirp, bracketed
    by elementwise chirp multiplies:

    * ``M ≤ fused_max`` — TWO passes, the §2.3.2 call-count discipline kept:
      ``stage="fwd"`` fuses chirp-pre, the zero-pad and the forward pad-FFT
      ⊙ B̂ into one kernel; ``stage="inv"`` fuses the inverse pad-FFT, the
      slice back to ``n`` and the chirp-post into the second.
    * ``M > fused_max`` — the pad length's own pow2 split program runs the
      conv: ``pre`` → forward program of M → ``mul`` (⊙B̂) → inverse
      program of M → ``post``, with each inner pass's direction pinned via
      :attr:`Pass.inverse` (the outer fft/ifft choice only flips the chirp
      LUTs, never the conv).
    """
    if _is_pow2(n):
        raise faults.PlanError(f"n={n} is a power of two; use compile_passes")
    if n < 2:
        raise faults.PlanError(f"Bluestein lengths start at 2, got {n}")
    m_pad = bluestein_pad(n) if pad is None else pad
    if not _is_pow2(m_pad) or m_pad < 2 * n - 1:
        raise faults.PlanError(
            f"bluestein pad must be a power of two ≥ 2n-1 = {2 * n - 1}, "
            f"got {m_pad}"
        )
    if m_pad <= fused_max:
        return (
            Pass(
                kind="bluestein", n=n, n1=m_pad,
                view_in=(1, 1, n), view_out=(1, 1, m_pad),
                order="natural", stage="fwd",
            ),
            Pass(
                kind="bluestein", n=n, n1=m_pad,
                view_in=(1, 1, m_pad), view_out=(1, 1, n),
                order="natural", stage="inv",
            ),
        )
    inner = compile_passes(m_pad, fused_max, "natural", direct_max)
    if any(p.kind == "reorder" for p in inner):
        raise NotImplementedError(
            f"bluestein pads beyond fused_max² ({fused_max**2}) would need "
            f"a reordered inner program; pad={m_pad}"
        )
    flat_n = (1, 1, n)
    flat_m = (1, 1, m_pad)
    passes = [
        Pass(kind="bluestein", n=n, n1=m_pad, view_in=flat_n,
             view_out=flat_m, order="natural", stage="pre"),
    ]
    passes.extend(dataclasses.replace(p, inverse=False) for p in inner)
    passes.append(
        Pass(kind="bluestein", n=n, n1=m_pad, view_in=flat_m,
             view_out=flat_m, order="natural", stage="mul")
    )
    passes.extend(dataclasses.replace(p, inverse=True) for p in inner)
    passes.append(
        Pass(kind="bluestein", n=n, n1=m_pad, view_in=flat_m,
             view_out=flat_n, order="natural", stage="post")
    )
    return tuple(passes)


def joint2d_supported(n2: int, fused_max: int = FUSED_MAX) -> bool:
    """Whether an ``(..., n2, n)`` image compiles into ONE joint program:
    fused-regime columns, or strip-mined columns of at most two factors
    (``n2 ≤ fused_max²``).  Beyond that the column program would need a
    digit-reversal relayout down axis -2 and ``fft.plan()`` composes
    per-axis plans instead.  The explicit form of the
    :func:`compile_passes2d` gate, so callers can branch without catching
    its ``NotImplementedError``."""
    return _is_pow2(n2) and (
        n2 <= fused_max or len(program_factors(n2, fused_max)) <= 2
    )


@functools.lru_cache(maxsize=256)
def compile_passes2d(
    n: int, n2: int, fused_max: int = FUSED_MAX, direct_max: int = DIRECT_MAX
) -> tuple[Pass, ...]:
    """Compile the joint pass program of an ``(..., n2, n)`` 2-D transform.

    Row passes first — the 1-D program of the last axis, executed over
    ``batch × n2`` contiguous rows — then the column passes down axis -2.
    Fused-regime columns (``n2 ≤ fused_max``) are one in-place strided
    column pass: the whole image is the pencil view ``(b, n2, n)`` and the
    column kernel transforms its middle axis, so the row→column handoff
    never materialises an HBM transpose (the §2.3.2 discipline extended to
    the paper's image workload).

    Beyond the fused regime the columns are **strip-mined**: the 1-D split
    program of ``n2`` re-tagged ``axis=-2`` — strided multi-factor column
    passes whose pencil views decompose the n2 axis exactly like the 1-D
    flat buffer, with the image width riding along as extra pencil columns
    (swept chunk-by-chunk) and the inter-factor twiddle broadcast across
    the width inside the kernel.  Taller-than-``fused_max²`` images would
    additionally need a digit-reversal relayout down axis -2 and stay
    gated.
    """
    if not _is_pow2(n2):
        raise faults.PlanError(f"FFT length must be a power of two, got {n2}")
    passes = list(compile_passes(n, fused_max, "natural", direct_max))
    if n2 <= fused_max:
        if n2 > 1:
            leaf = _leaf_pass(n2, direct_max)
            passes.append(
                Pass(
                    kind=leaf.kind,
                    n=n2,
                    n1=leaf.n1,
                    n2=leaf.n2,
                    view_in=(1, 1, n2),
                    view_out=(1, 1, n2),
                    order="natural",
                    axis=-2,
                )
            )
        return tuple(passes)
    col_passes = compile_passes(n2, fused_max, "natural", direct_max)
    if any(p.kind == "reorder" for p in col_passes):
        raise NotImplementedError(
            f"strip-mined column programs cover n2 ≤ fused_max² "
            f"({fused_max**2}); n2={n2} would need a digit-reversal "
            f"relayout pass down axis -2.  fft.plan(FFTSpec(kind='fft2')) "
            f"composes per-axis plans instead for such images."
        )
    passes.extend(dataclasses.replace(p, axis=-2) for p in col_passes)
    return tuple(passes)


@functools.lru_cache(maxsize=512)
def plan_fft(
    n: int,
    fused_max: int = FUSED_MAX,
    direct_max: int = DIRECT_MAX,
    pad: int | None = None,
) -> FFTPlan:
    """Plan a length-``n`` complex FFT.

    Power-of-two lengths compile to the native direct/fused/split programs;
    any other ``n ≥ 2`` compiles to the Bluestein chirp-conv program
    (:func:`compile_bluestein`), with ``pad`` optionally overriding the
    conv pad length (the tuner's knob — pow2, ≥ 2n−1).
    """
    if n < 1:
        raise faults.PlanError(f"FFT length must be positive, got {n}")
    if not _is_pow2(n):
        passes = compile_bluestein(n, pad, fused_max, direct_max)
        m_pad = passes[0].n1
        leaves = [passes[0]]  # the chirp leaf: one entry per p.n == n
        if m_pad > fused_max:
            # Split-regime conv: the pad length's own leaves tile the
            # inner program's kernels.
            leaves.extend(plan_fft(m_pad, fused_max, direct_max).leaf_passes)
        return FFTPlan(
            n=n,
            levels=(),
            leaf_passes=tuple(sorted(leaves, key=lambda p: p.n)),
            passes=passes,
        )
    if pad is not None:
        raise faults.PlanError("pad applies only to non-power-of-two lengths")
    levels: list[tuple[int, int]] = []
    m = n
    while m > fused_max:
        # Keep the inner factor in the fused regime, outer as small as
        # possible: each level's twiddle grid and transpose cost scale with
        # the outer factor.
        n_outer, n_inner = balanced_split(m, cap=fused_max)
        levels.append((n_outer, n_inner))
        m = n_outer  # the outer transform may itself need splitting
        if n_inner <= fused_max and n_outer <= fused_max:
            break
    # Distinct leaf lengths (outer and inner of the last level, or n itself).
    if levels:
        leaf_lengths = {levels[-1][0], levels[-1][1]}
        for i in range(len(levels) - 1):
            leaf_lengths.add(levels[i][1])
    else:
        leaf_lengths = {n}
    leaves = tuple(
        sorted((_leaf_pass(m, direct_max) for m in leaf_lengths), key=lambda p: p.n)
    )
    return FFTPlan(
        n=n,
        levels=tuple(levels),
        leaf_passes=leaves,
        passes=compile_passes(n, fused_max, "natural", direct_max),
    )


@functools.lru_cache(maxsize=256)
def plan_fft2(
    n: int, n2: int, fused_max: int = FUSED_MAX, direct_max: int = DIRECT_MAX
) -> FFTPlan:
    """Plan an ``(..., n2, n)`` 2-D complex FFT as ONE linearized program.

    ``n`` is the last-axis (row) length, ``n2`` the second-to-last (column)
    length.  The returned plan's ``passes`` mix ``axis=-1`` row passes with
    the in-place ``axis=-2`` column pass — a single compiled schedule, no
    per-axis child plans and no transposes between the axes.
    """
    row_plan = plan_fft(n, fused_max, direct_max)
    # Keep the row plan's leaves verbatim (a non-pow2 row length's leaf is
    # the Bluestein chirp pass itself — not re-derivable from its length);
    # strip-mined columns contribute one leaf per column factor.
    leaf_map = {p.n: p for p in row_plan.leaf_passes}
    if n2 > 1:
        for m in program_factors(n2, fused_max):
            leaf_map.setdefault(m, _leaf_pass(m, direct_max))
    leaves = tuple(sorted(leaf_map.values(), key=lambda p: p.n))
    return FFTPlan(
        n=n,
        levels=row_plan.levels,
        leaf_passes=leaves,
        passes=compile_passes2d(n, n2, fused_max, direct_max),
        n2=n2,
    )


def vmem_bytes(p: Pass, batch_tile: int) -> int:
    """Estimated VMEM working set of one grid step of a leaf pass.

    Split-complex float32 everywhere: signal tile in + out, DFT matrices,
    twiddle grid, one intermediate.  Used by the kernel launcher to pick the
    batch tile so the block fits comfortably in ~16 MB of VMEM (we budget
    half of it, leaving room for Mosaic's double buffering).
    """
    f32 = 4
    if p.kind == "bluestein":
        # The chirp leaf's working set is pad-sized: the padded signal tile
        # in/mid/out, the inner pad-FFT's LUTs (fwd/inv stages only), and
        # the (1, n)/(1, M) chirp planes.
        m_pad = p.n1
        sig = batch_tile * m_pad * 2 * f32
        chirps = (p.n + m_pad) * 2 * f32
        mats = 0
        if p.stage in ("fwd", "inv"):
            inner = _leaf_pass(m_pad)
            if inner.kind == "direct":
                mats = m_pad * m_pad * 2 * f32
            else:
                mats = (
                    inner.n1 * inner.n1 + inner.n2 * inner.n2
                    + inner.n1 * inner.n2
                ) * 2 * f32
        return 3 * sig + mats + chirps
    if p.kind == "direct":
        sig = batch_tile * p.n * 2 * f32
        mats = p.n * p.n * 2 * f32
        return 2 * sig + mats
    sig = batch_tile * p.n * 2 * f32             # x tile (= n1*n2 grid)
    mats = (p.n1 * p.n1 + p.n2 * p.n2) * 2 * f32  # W1, W2
    tw = p.n1 * p.n2 * 2 * f32                    # twiddle grid
    return 3 * sig + mats + tw                    # in, intermediate, out


def pick_batch_tile(p: Pass, budget: int = VMEM_BUDGET) -> int:
    """Largest power-of-two batch tile whose working set fits the budget."""
    bt = 512
    while bt > 1 and vmem_bytes(p, bt) > budget:
        bt //= 2
    return bt


#: K-loop staging depth of the Triton GEMM pipeline: the leaf's LUT operands
#: stream through shared memory in (GPU_LUT_STAGE x tile) stripes rather than
#: residing whole, so only one stripe per operand is charged to the budget.
GPU_LUT_STAGE = 32


def gpu_smem_bytes(p: Pass, batch_tile: int) -> int:
    """Modeled per-program shared-memory working set of the GPU row leaf.

    Differs from :func:`vmem_bytes` in what counts as resident: on TPU the
    whole DFT matrix / twiddle grid sits in VMEM for the block; on a CUDA SM
    the signal tiles are resident but the LUT operands are software-pipelined
    through shared memory one :data:`GPU_LUT_STAGE`-deep stripe at a time
    (the Triton ``dot`` K loop).  Charging the full LUTs against a 48-228 KB
    budget would force every tile to 1 and misreport the paper's metric.
    """
    f32 = 4
    if p.kind == "bluestein":
        # Pad-sized tiles; the inner pad-FFT's LUTs pipeline in stripes and
        # the chirp planes are 1-row operands (charged whole, they're tiny
        # next to the signal tiles).
        m_pad = p.n1
        sig = batch_tile * m_pad * 2 * f32
        chirps = (p.n + m_pad) * 2 * f32
        stripes = 0
        if p.stage in ("fwd", "inv"):
            inner = _leaf_pass(m_pad)
            if inner.kind == "direct":
                stripes = GPU_LUT_STAGE * m_pad * 2 * f32
            else:
                stripes = GPU_LUT_STAGE * (inner.n1 + 2 * inner.n2) * 2 * f32
        return 3 * sig + stripes + chirps
    if p.kind == "direct":
        sig = batch_tile * p.n * 2 * f32
        stripe = GPU_LUT_STAGE * p.n * 2 * f32
        return 2 * sig + stripe                       # in, out + W stripe
    sig = batch_tile * p.n * 2 * f32
    stripes = GPU_LUT_STAGE * (p.n1 + p.n2) * 2 * f32  # W1, W2 stripes
    tw = GPU_LUT_STAGE * p.n2 * 2 * f32                # twiddle-grid stripe
    return 3 * sig + stripes + tw                      # in, mid, out


def pick_batch_tile_gpu(p: Pass, budget: int | None = None) -> int:
    """Largest power-of-two batch tile whose GPU shared-memory working set
    fits ``budget`` (default: the resolved :func:`~repro_torch.core.limits.memory_budget`
    of the first visible device)."""
    if budget is None:
        budget = memory_budget()
    bt = 512
    while bt > 1 and gpu_smem_bytes(p, bt) > budget:
        bt //= 2
    return bt


def pass_hbm_bytes(p: Pass, batch: int = 1, other: int = 1) -> int:
    """Modeled HBM traffic of one program pass, split-complex float32.

    Signal read + signal write, plus the chunked twiddle LUT (streamed once
    per pass through its BlockSpec) and the transform LUTs (pinned to block
    (0, 0), so fetched from HBM once regardless of grid size).  This is the
    figure ``launch.dryrun`` / ``analysis.roofline`` report per pass so the
    round-trip count is observable, and what the tests assert.

    ``other`` is the multi-axis multiplier: the length of the image axis the
    pass does *not* transform (``n2`` for row passes, the row length ``n``
    for column passes — every 2-D pass streams the whole image).
    """
    f32 = 4
    if p.kind == "reorder":
        return 2 * batch * other * p.n * 2 * f32
    if p.kind == "bluestein":
        # In and out widths differ (n → M on the way in, M → n back out);
        # chirp planes stream once, and the fused fwd/inv stages carry the
        # inner pad-FFT's LUTs.
        n_in = p.view_in[2] if p.view_in else p.n
        n_out = p.view_out[2] if p.view_out else p.n
        sig = batch * other * (n_in + n_out) * 2 * f32
        luts = (p.n + p.n1) * 2 * f32
        if p.stage in ("fwd", "inv"):
            inner = _leaf_pass(p.n1)
            if inner.kind == "direct":
                luts += p.n1 * p.n1 * 2 * f32
            else:
                luts += (
                    inner.n1 * inner.n1 + inner.n2 * inner.n2
                    + inner.n1 * inner.n2
                ) * 2 * f32
        return sig + luts
    pencils, _stride, f = p.view_in if p.view_in else (1, 1, p.n)
    sig = batch * other * pencils * f * 2 * f32
    tw = 0
    if p.twiddle_after:
        tw = p.twiddle_after[0] * p.twiddle_after[1] * 2 * f32
    if p.kind == "direct":
        luts = p.n * p.n * 2 * f32
    else:
        luts = (p.n1 * p.n1 + p.n2 * p.n2 + p.n1 * p.n2) * 2 * f32
    return 2 * sig + tw + luts


def pass_other(p: Pass, plan: FFTPlan) -> int:
    """The non-transformed image-axis length a pass of ``plan`` streams —
    the ``other`` multiplier :func:`pass_hbm_bytes` charges (1 for 1-D)."""
    if plan.n2 is None:
        return 1
    return plan.n if p.axis == -2 else plan.n2


def program_hbm_bytes(
    passes: tuple[Pass, ...], batch: int = 1, shape2d: tuple | None = None
) -> int:
    """Total modeled HBM traffic of a pass program.

    ``shape2d=(n2, n)`` scales each pass by the image axis it streams but
    does not transform (a 2-D program's passes all touch the whole image).
    """
    if shape2d is None:
        return sum(pass_hbm_bytes(p, batch) for p in passes)
    n2, n = shape2d
    return sum(
        pass_hbm_bytes(p, batch, n if p.axis == -2 else n2) for p in passes
    )


def _pass_chunk_bytes(p: Pass, c: int) -> int:
    """VMEM working set of one grid step of a pencil pass with chunk ``c``."""
    f32 = 4
    if p.kind == "bluestein":
        # Whole-signal chirp passes are batch-tiled, never chunked; charge
        # the tile model so a defensive caller still gets a sane bound.
        return vmem_bytes(p, c)
    sig = p.n * c * 2 * f32
    tw = sig if p.twiddle_after else 0
    if p.kind == "direct":
        luts = p.n * p.n * 2 * f32
    else:
        luts = (p.n1 * p.n1 + p.n2 * p.n2 + p.n1 * p.n2) * 2 * f32
    return 3 * sig + tw + luts  # in, intermediate, out (+ twiddle slab)


def pick_pass_chunk(
    p: Pass, budget: int = VMEM_BUDGET, width: int | None = None
) -> int:
    """Per-grid-step chunk (columns for strided passes, rows for contiguous
    ones) — largest power of two fitting the VMEM budget.

    ``width`` overrides the chunked-axis length — 2-D column passes chunk
    the image width (possibly the n//2+1 bins of an rfft2 half-spectrum),
    which the per-axis pencil view cannot know.  Non-power-of-two widths
    start from the largest power of two below them; the executor pads the
    last partial chunk.

    The budget is binding: for large factors the chunk drops below one
    128-lane tile (padded sublanes beat a working set that Mosaic cannot
    place in VMEM at all — interpret-mode CI would never catch that)."""
    if width is None:
        pencils, stride, _f = p.view_in
        width = stride if stride > 1 else pencils
    c = 1 << (max(width, 1).bit_length() - 1)  # largest pow2 <= width
    while c > 1 and _pass_chunk_bytes(p, c) > budget:
        c //= 2
    return max(c, 1)


def describe_program(p: FFTPlan, batch: int = 1) -> str:
    """Human-readable pass program, e.g. for logging/EXPERIMENTS.md."""
    if p.n2 is not None:
        head = f"N={p.n2}x{p.n} (axis -2 x axis -1)"
    else:
        head = f"N={p.n}"
    parts = [f"{head}: {p.hbm_round_trips} HBM round trip(s)"]
    for i, ps in enumerate(p.passes):
        mb = pass_hbm_bytes(ps, batch, pass_other(ps, p)) / 1e6
        if ps.kind == "reorder":
            parts.append(f"pass {i}: digit-reversal reorder (~{mb:.1f} MB)")
            continue
        if ps.kind == "bluestein":
            stage_txt = {
                "fwd": "chirp-pre + pad-FFT ⊙ B̂ (fused)",
                "inv": "pad-IFFT + chirp-post (fused)",
                "pre": "chirp pre-multiply + zero-pad",
                "mul": "⊙ B̂ chirp spectrum",
                "post": "slice + chirp post-multiply",
            }.get(ps.stage, ps.stage)
            parts.append(
                f"pass {i}: bluestein n={ps.n} pad={ps.n1} {stage_txt} "
                f"(~{mb:.1f} MB)"
            )
            continue
        pencils, stride, f = ps.view_in
        algo = (
            f"direct DFT n={f}"
            if ps.kind == "direct"
            else f"fused four-step n={f} ({ps.n1} x {ps.n2})"
        )
        if ps.axis == -2 and pencils > 1:
            layout = (
                f"axis -2 strip-mined cols {pencils}x{f} stride={stride} "
                f"(width {p.n})"
            )
        elif ps.axis == -2:
            layout = f"axis -2 in-place columns (width {p.n})"
        elif pencils == 1:
            layout = "whole-signal"
        elif stride == 1:
            layout = f"{pencils} rows"
        else:
            layout = f"{pencils} cols stride={stride}"
        tw = (
            f" + twiddle {ps.twiddle_after[0]}x{ps.twiddle_after[1]}"
            if ps.twiddle_after
            else ""
        )
        fold = " -> natural order (fused write)" if ps.view_out != ps.view_in else ""
        parts.append(f"pass {i}: {layout} {algo}{tw}{fold} (~{mb:.1f} MB)")
    return "; ".join(parts)


def describe(n: int, batch: int = 1, n2: int | None = None) -> str:
    """Describe the pass program for a 1-D length-``n`` transform, or — with
    ``n2`` — the joint multi-axis program of an ``(..., n2, n)`` 2-D one."""
    return describe_program(plan_fft2(n, n2) if n2 is not None else plan_fft(n), batch)


# ---------------------------------------------------------------------------
# Carrying a pass program across packages as plain data
# ---------------------------------------------------------------------------

_PASS_FIELDS = tuple(f.name for f in dataclasses.fields(Pass))


def pass_record(p) -> dict:
    """One pass as a plain dict of its fields (works on any object with the
    :class:`Pass` field names — the reference's ``Pass`` included)."""
    return {name: getattr(p, name) for name in _PASS_FIELDS}


def _as_pass(rec) -> Pass:
    if isinstance(rec, Pass):
        return rec
    if isinstance(rec, dict):
        unknown = set(rec) - set(_PASS_FIELDS)
        if unknown:
            raise faults.PlanError(f"unknown pass fields {sorted(unknown)}")
        fields = dict(rec)
    elif isinstance(rec, (tuple, list)):
        if len(rec) > len(_PASS_FIELDS):
            raise faults.PlanError(
                f"a pass record has at most {len(_PASS_FIELDS)} fields, got {len(rec)}"
            )
        fields = dict(zip(_PASS_FIELDS, rec))
    else:
        raise faults.PlanError(f"cannot read a pass from {type(rec).__name__}")
    for key in ("view_in", "view_out", "twiddle_after"):
        if fields.get(key) is not None:
            fields[key] = tuple(fields[key])
    return Pass(**fields)


def plan_from_records(records, n: int | None = None, n2: int | None = None) -> FFTPlan:
    """Build an :class:`FFTPlan` from a pass program given as plain data.

    ``records`` is a sequence of passes, each a dict of :class:`Pass` field
    names or a tuple in field order (``kind, n, n1, n2, view_in, view_out,
    twiddle_after, order, axis, stage, inverse``).  This is how a test
    carries the reference planner's program across without this package
    importing the reference.  ``n`` defaults to the transform length the
    program implies; ``levels`` and ``leaf_passes`` are re-derived for
    pow2 1-D programs.
    """
    passes = tuple(_as_pass(r) for r in records)
    if not passes:
        raise faults.PlanError("a pass program needs at least one pass")
    if n is None:
        first = passes[0]
        n = first.n if first.kind == "bluestein" else first.view_in[0] * first.view_in[2]
    if n2 is None and _is_pow2(n):
        derived = plan_fft(n)
        return dataclasses.replace(derived, passes=passes)
    leaves = {p.n: _leaf_pass(p.n) for p in passes if p.kind in ("direct", "fused4")}
    return FFTPlan(
        n=n,
        levels=(),
        leaf_passes=tuple(sorted(leaves.values(), key=lambda p: p.n)),
        passes=passes,
        n2=n2,
    )
