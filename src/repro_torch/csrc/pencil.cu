// Pass kernels of the split regime (n > 65536) and of the 2-D programs.
//
// cols_pass  replaces cols_pass_call (src/repro/kernels/pencil.py:102,
//            pallas_call at :149): on an (R, f, s) view, a length-f
//            transform down the middle axis of every column, times the
//            inter-factor twiddle T[k, c] (an (f, s) LUT, streamed once).
//            tw_every = w: the twiddle is an (f, s / w) grid whose column
//            c / w serves a run of w columns (the strided factor of a
//            strip-mined 2-D column program, where the image width rides
//            along as columns) -- address arithmetic, no grid at image
//            width.  A power-of-two w is a shift (c >> log2 w), any other
//            w a division.  s may be any width (an rfft2 half-spectrum is
//            m + 1 columns): the last chunk of columns is masked.
// rows_natural replaces rows_natural_call (src/repro/kernels/pencil.py:178,
//            pallas_call at :203): on a (B, p, f) view, a length-f transform
//            of every row, written transposed to (B, f, p) so the program's
//            output lands in natural order with no transpose pass.
// cols_natural replaces cols_natural_call (src/repro/kernels/pencil.py:234,
//            pallas_call at :265): on a (B, P, f, w) view, a length-f
//            transform down axis 2, written as (B, f, P, w) -- the n2-axis
//            digit transpose of a strip-mined column program fused into the
//            write.  It is cols_pass's column engine on the (B P, f, w)
//            view with no twiddle and another store: column group r =
//            (b, p) writes bin k to row k of pencil b at offset p w, rows a
//            stride P w apart (cols_pass: in place, stride s).
//
// All three are radix FFTs on the engine of radix.cuh, as dft_matmul and
// fft4step are: butterflies in registers, the exchanges between stages in
// padded shared memory, every stage twiddle (and the four-step's
// w_f^(k1 j2)) from the one table of f-th roots on the read-only path, the
// inverse's 1/f at the store.  The function is bound by bytes on the H100
// (5 f log2 f flops over 16 f bytes per signal), so the kernels move each
// point as few times as they can, in one of two forms; the wrapper picks
// one per f (pencil.COLS_TILE / ROWS_TILE, the fastest measured on the
// H100: on-chip tiles to f = 2048, the slab from 4096):
//
// * On-chip tile (f <= 16384): a block transforms C = 2^t / f adjacent
//   signals, a tile of 2^t = 4096, 8192 or 16384 points (fft4step.cu's
//   three whole-signal configurations), reading each point once and writing
//   it once.  cols_radix_kernel takes C adjacent columns, the unit-stride
//   axis (Geo sig_fast), so each row of the tile is one contiguous run of C
//   floats per plane; rows_radix_kernel takes C adjacent rows (contiguous
//   reads).  The last stage of either leaves the bins in shared memory
//   (padded by one word per f), and the store walks the signals with unit
//   stride, so bin k's C outputs are one contiguous run (of the column's
//   row k, times the twiddle, of cols_natural's output row, or of the
//   (B, f, p) output).  With C >= 8 (f <= 2048) every run is a whole
//   32-byte sector; with C < 8 a run is part of a sector, which measured
//   slower than the slab's two round trips (the L2 does not merge
//   neighbouring blocks' parts).  A width that is no multiple of C ends in
//   a masked chunk; a width below C (cols_natural's w < 2^t / f) masks
//   C - w columns of every tile: the block computes C / w times the
//   transforms it stores, and its runs are w floats (part of a sector when
//   w < 8).
// * Scratch slab (1024 <= f <= 65536):
//   cols_slab_kernel / rows_slab_kernel keep the planner's four-step
//   f = n1 x n2 for 8 adjacent columns (rows), so every access is a whole
//   sector: phase 1, the n1-point FFTs of the 8 n2 sub-columns, times
//   w_f^(k1 j2), into the block's slice of a global scratch slab; after a
//   block barrier, phase 2, the n2-point FFTs, stored to bin k2 n1 + k1
//   (the columns' twiddle applied there; the rows' through shared memory so
//   each output row gets its 8 adjacent q).  Two round trips per point:
//   at most half the byte bound.
//
// The column kernels are instantiated twice: NAT = false for cols_pass and
// NAT = true for cols_natural, whose group r takes one 32-bit division by
// P for its output base, so cols_pass's build has none of it.
#include "radix.cuh"

using namespace repro;

// ---------------------------------------------------------------------------
// The radix pass kernels
// ---------------------------------------------------------------------------

// The inter-factor twiddle of column c: T[k, c >> lgw] (lgw >= 0) or
// T[k, c / w] of the (f, s / w) grid with row stride ts; none when tr is
// null.  Columns sit below 2^31.
struct Twiddle {
  const float* tr;
  const float* ti;
  i64 ts;
  int lgw;
  int w;
  __device__ __forceinline__ float2 apply(float2 v, int k, i64 c) const {
    if (tr == nullptr) return v;
    const i64 off = (i64)k * ts + (lgw >= 0 ? (int)c >> lgw : (int)c / w);
    return cmulf(v, make_float2(ldro(tr + off), ldro(ti + off)));
  }
};

namespace {

// The on-chip tiles and the slab kernels' 8192-point tile are radix.cuh's
// (fft4step.cu's); a slab block takes 8 columns (rows): one 32-byte sector
// per plane.
constexpr int LGQ = 3;

// Column c of a tile of adjacent columns: position j at x + j * s + c, of
// which only the first cv columns exist (a ragged last chunk).
struct StridedLoad {
  const float* xr;
  const float* xi;
  i64 s;
  int cv;
  __device__ __forceinline__ void operator()(int sig, int pos, float2& v) const {
    if (sig >= cv) {
      v = make_float2(0.f, 0.f);
      return;
    }
    const i64 off = (i64)pos * s + sig;
    v = make_float2(xr[off], xi[off]);
  }
};

// Bin k of the tile's signal c (image column c0 + c) to y + k * os + c,
// os the output's row stride, times the scale and the twiddle (of
// cols_pass; none for cols_natural or the rows).
struct StridedStore {
  float* yr;
  float* yi;
  i64 os;
  int cv;
  float scale;
  i64 c0;
  Twiddle t;
  __device__ __forceinline__ void operator()(int sig, int bin, float2 v) const {
    if (sig >= cv) return;
    v = t.apply(make_float2(v.x * scale, v.y * scale), bin, c0 + sig);
    const i64 off = (i64)bin * os + sig;
    yr[off] = v.x;
    yi[off] = v.y;
  }
};

// Phase 1 of cols_slab_kernel: signal g = t0 + sig is (j2 = g >> 3,
// c = g & 7), position j1 at row j1 n2 + j2 of column c.
struct SlabColLoad {
  const float* xr;
  const float* xi;
  i64 s;
  int lg2;
  int t0;
  int cv;
  __device__ __forceinline__ void operator()(int sig, int pos, float2& v) const {
    const int g = t0 + sig;
    if ((g & 7) >= cv) {
      v = make_float2(0.f, 0.f);
      return;
    }
    const i64 off = (i64)((pos << lg2) + (g >> LGQ)) * s + (g & 7);
    v = make_float2(xr[off], xi[off]);
  }
};

// Bin k1 of signal (j2, c), times w_f^(k1 j2), to the block's slab at
// (k1, j2, c): (k1 n2 + j2) 8 + c.
struct SlabColStore {
  float* mr;
  float* mi;
  int lg2;
  int t0;
  int cv;
  Roots w;
  __device__ __forceinline__ void operator()(int sig, int bin, float2 v) const {
    const int g = t0 + sig;
    if ((g & 7) >= cv) return;
    v = cmulf(v, w(bin * (g >> LGQ)));  // k1 j2 < n1 n2: no wrap
    const int off = (bin << (lg2 + LGQ)) + g;
    mr[off] = v.x;
    mi[off] = v.y;
  }
};

// Phase 2 of cols_slab_kernel: signal g = t0 + sig is (k1 = g >> 3,
// c = g & 7), position j2 at the slab's (k1, j2, c).
struct SlabRowLoad {
  const float* mr;
  const float* mi;
  int lg2;
  int t0;
  int cv;
  __device__ __forceinline__ void operator()(int sig, int pos, float2& v) const {
    const int g = t0 + sig;
    if ((g & 7) >= cv) {
      v = make_float2(0.f, 0.f);
      return;
    }
    const int off = ((g >> LGQ) << (lg2 + LGQ)) + (pos << LGQ) + (g & 7);
    v = make_float2(mr[off], mi[off]);
  }
};

// Bin k2 of signal (k1, c) is bin k = k2 n1 + k1 of column c0 + c: to
// y + k * os + c, os the output's row stride, times the scale and the
// twiddle.
struct SlabColOut {
  float* yr;
  float* yi;
  i64 os;
  int lg1;
  int t0;
  int cv;
  float scale;
  i64 c0;
  Twiddle t;
  __device__ __forceinline__ void operator()(int sig, int bin, float2 v) const {
    const int g = t0 + sig;
    const int c = g & 7;
    if (c >= cv) return;
    const int k = (bin << lg1) + (g >> LGQ);
    v = t.apply(make_float2(v.x * scale, v.y * scale), k, c0 + c);
    const i64 off = (i64)k * os + c;
    yr[off] = v.x;
    yi[off] = v.y;
  }
};

// Phase 1 of rows_slab_kernel: signal g = t0 + sig is (q = g >> lg2,
// j2 = g & (n2 - 1)), position j1 at j1 n2 + j2 of row q.
struct SlabRowColLoad {
  const float* xr;
  const float* xi;
  int lgf;
  int lg2;
  int t0;
  int cv;
  __device__ __forceinline__ void operator()(int sig, int pos, float2& v) const {
    const int g = t0 + sig;
    if ((g >> lg2) >= cv) {
      v = make_float2(0.f, 0.f);
      return;
    }
    const int off = ((g >> lg2) << lgf) + (pos << lg2) + (g & ((1 << lg2) - 1));
    v = make_float2(xr[off], xi[off]);
  }
};

// Bin k1 of signal (q, j2), times w_f^(k1 j2), to the slab's row q at
// k1 n2 + j2.
struct SlabRowColStore {
  float* mr;
  float* mi;
  int lgf;
  int lg2;
  int t0;
  int cv;
  Roots w;
  __device__ __forceinline__ void operator()(int sig, int bin, float2 v) const {
    const int g = t0 + sig;
    if ((g >> lg2) >= cv) return;
    const int j2 = g & ((1 << lg2) - 1);
    v = cmulf(v, w(bin * j2));
    const int off = ((g >> lg2) << lgf) + (bin << lg2) + j2;
    mr[off] = v.x;
    mi[off] = v.y;
  }
};

// Phase 2 of rows_slab_kernel: signal g = t0 + sig is (k1 = g >> 3,
// q = g & 7), position j2 at the slab's row q, k1 n2 + j2.
struct SlabQLoad {
  const float* mr;
  const float* mi;
  int lgf;
  int lg2;
  int t0;
  int cv;
  __device__ __forceinline__ void operator()(int sig, int pos, float2& v) const {
    const int g = t0 + sig;
    if ((g & 7) >= cv) {
      v = make_float2(0.f, 0.f);
      return;
    }
    const int off = ((g & 7) << lgf) + ((g >> LGQ) << lg2) + pos;
    v = make_float2(mr[off], mi[off]);
  }
};

// Words between the rows of a stage_out buffer: one pad word per 2^lgp,
// at least per 32 so the padded tile fits the buffer (xwords).
__device__ __forceinline__ int pad_log2(int lgl) { return lgl > 5 ? lgl : 5; }

// The store of a stage_out tile (bins at oaddr(g, lgp, signal, bin)):
// consecutive threads on consecutive signals, so bin k's outputs are one
// contiguous run, and reads from the buffer padded per 2^lgp = 2^lgl free
// of bank conflicts.  A loop of runtime length, not unrolled into the
// registers of all of a thread's points (that spilled).
template <int T, class ST>
__device__ __forceinline__ void store_by_bin(const Geo& g, int lgp, const float* xre,
                                             const float* xim, const ST& st) {
  for (int i = threadIdx.x; i < (1 << (g.lgc + g.lgl)); i += T) {
    const int sig = i & ((1 << g.lgc) - 1);
    const int a = oaddr(g, lgp, sig, i >> g.lgc);
    st(sig, i >> g.lgc, make_float2(xre[a], xim[a]));
  }
}

// Where column group r of an (R, f, s) view writes, and the row stride:
// NAT (cols_natural, R = B P): group r = (b, p) = (r / P, r % P) to row k
// of (B, f, P, s) at (b f P + p) s, stride P s; else (cols_pass) in place,
// r f s and s.  r < 2^31 (one block each): a 32-bit division.
template <bool NAT>
__device__ __forceinline__ void cols_out(i64 r, int lgf, i64 s, unsigned P, i64& out, i64& os) {
  if constexpr (NAT) {
    const unsigned b = (unsigned)r / P;
    out = (((i64)b * P << lgf) + ((unsigned)r - b * P)) * s;
    os = (i64)P * s;
  } else {
    out = (r << lgf) * s;
    os = s;
  }
}

}  // namespace

// One tile of C = 2^lgc adjacent columns of view r: block b is chunk
// b % chunks of view b / chunks; its bins go where cols_out<NAT> says.
template <int T, int E, int MB, bool NAT>
__global__ void __launch_bounds__(T, MB)
    cols_radix_kernel(int lgf, int lgc, i64 s, i64 chunks, unsigned P, float scale,
                      const float* __restrict__ xr, const float* __restrict__ xi,
                      const float* __restrict__ wr, const float* __restrict__ wi, Twiddle tw,
                      float* yr, float* yi) {
  extern __shared__ float2 smem[];
  float* xre = reinterpret_cast<float*>(smem);
  float* xim = xre + xwords(T * E);
  const i64 r = blockIdx.x / (unsigned)chunks;  // chunks < 2^31: no 64-bit division
  const i64 c0 = (i64)(blockIdx.x % (unsigned)chunks) << lgc;
  const int cv = s - c0 < (1LL << lgc) ? (int)(s - c0) : 1 << lgc;
  const i64 base = (r << lgf) * s + c0;
  const Geo g{lgf, lgc, true};
  const int lgp = pad_log2(lgf);
  const StridedLoad ld{xr + base, xi + base, s, cv};
  if (lgf == 0) {  // length 1: the transform is the identity (the engine would store it)
    for (int c = threadIdx.x; c < (1 << lgc); c += T) {
      float2 v;
      ld(c, 0, v);
      const int a = oaddr(g, lgp, c, 0);
      xre[a] = v.x;
      xim[a] = v.y;
    }
    __syncthreads();
  } else {
    radix_fft<T, E>(g, roots_table(wr, wi, lgf), xre, xim, ld, NoStore(), lgp);
  }
  i64 out, os;
  cols_out<NAT>(r, lgf, s, P, out, os);
  out += c0;
  store_by_bin<T>(g, lgp, xre, xim, StridedStore{yr + out, yi + out, os, cv, scale, c0, tw});
}

// Eight adjacent columns of view r as the four-step f = n1 x n2 through
// the block's 8 f points of the slab (mr / mi); bins as cols_radix_kernel's.
template <bool NAT>
__global__ void __launch_bounds__(SL_T, 1)
    cols_slab_kernel(int lgf, int lg1, i64 s, i64 chunks, unsigned P, float scale,
                     const float* __restrict__ xr, const float* __restrict__ xi,
                     const float* __restrict__ wr, const float* __restrict__ wi, Twiddle tw,
                     float* yr, float* yi, float* mr, float* mi) {
  extern __shared__ float2 smem[];
  float* xre = reinterpret_cast<float*>(smem);
  float* xim = xre + xwords(1 << SL_LGM);
  const int lg2 = lgf - lg1;
  const i64 r = blockIdx.x / (unsigned)chunks;
  const i64 c0 = (i64)(blockIdx.x % (unsigned)chunks) << LGQ;
  const int cv = s - c0 < 8 ? (int)(s - c0) : 8;
  const i64 base = (r << lgf) * s + c0;
  const i64 slab = (i64)blockIdx.x << (lgf + LGQ);
  const Roots w = roots_table(wr, wi, lgf);

  // Phase 1: the n1-point FFT of every (j2, c), times w_f^(k1 j2).
  const int lgc1 = SL_LGM - lg1;
  for (int t0 = 0; t0 < (8 << lg2); t0 += 1 << lgc1)
    radix_fft<SL_T, SL_E>(Geo{lg1, lgc1, true}, w, xre, xim,
                          SlabColLoad{xr + base, xi + base, s, lg2, t0, cv},
                          SlabColStore{mr + slab, mi + slab, lg2, t0, cv, w});
  __syncthreads();  // the block's slab is complete and visible to it

  // Phase 2: the n2-point FFT of every (k1, c), to bin k2 n1 + k1.
  i64 out, os;
  cols_out<NAT>(r, lgf, s, P, out, os);
  out += c0;
  const int lgc2 = SL_LGM - lg2;
  for (int t0 = 0; t0 < (8 << lg1); t0 += 1 << lgc2)
    radix_fft<SL_T, SL_E>(Geo{lg2, lgc2, true}, w, xre, xim,
                          SlabRowLoad{mr + slab, mi + slab, lg2, t0, cv},
                          SlabColOut{yr + out, yi + out, os, lg1, t0, cv, scale, c0, tw});
}

// One tile of C = 2^lgc adjacent rows q0 + c of view b, written
// transposed: bin k of row q to y[b, k, q].
template <int T, int E, int MB>
__global__ void __launch_bounds__(T, MB)
    rows_radix_kernel(int lgf, int lgc, i64 p, i64 chunks, float scale,
                      const float* __restrict__ xr, const float* __restrict__ xi,
                      const float* __restrict__ wr, const float* __restrict__ wi, float* yr,
                      float* yi) {
  extern __shared__ float2 smem[];
  float* xre = reinterpret_cast<float*>(smem);
  float* xim = xre + xwords(T * E);
  const i64 b = blockIdx.x / (unsigned)chunks;  // chunks < 2^31: no 64-bit division
  const i64 q0 = (i64)(blockIdx.x % (unsigned)chunks) << lgc;
  const int cv = p - q0 < (1LL << lgc) ? (int)(p - q0) : 1 << lgc;
  const i64 in = (b * p + q0) << lgf;
  const i64 out = (b << lgf) * p + q0;
  const Geo g{lgf, lgc, false};
  const int lgp = pad_log2(lgf);
  radix_fft<T, E>(g, roots_table(wr, wi, lgf), xre, xim, RowLoad{xr + in, xi + in, lgf, cv},
                  NoStore(), lgp);
  const Twiddle none{nullptr, nullptr, 0, 0, 1};
  store_by_bin<T>(g, lgp, xre, xim, StridedStore{yr + out, yi + out, p, cv, scale, 0, none});
}

// Eight adjacent rows q0 + q of view b as the four-step f = n1 x n2
// through the block's 8 f points of the slab, written transposed.
__global__ void __launch_bounds__(SL_T, 1)
    rows_slab_kernel(int lgf, int lg1, i64 p, i64 chunks, float scale,
                     const float* __restrict__ xr, const float* __restrict__ xi,
                     const float* __restrict__ wr, const float* __restrict__ wi, float* yr,
                     float* yi, float* mr, float* mi) {
  extern __shared__ float2 smem[];
  float* xre = reinterpret_cast<float*>(smem);
  float* xim = xre + xwords(1 << SL_LGM);
  const int lg2 = lgf - lg1;
  const i64 b = blockIdx.x / (unsigned)chunks;
  const i64 q0 = (i64)(blockIdx.x % (unsigned)chunks) << LGQ;
  const int cv = p - q0 < 8 ? (int)(p - q0) : 8;
  const i64 in = (b * p + q0) << lgf;
  const i64 out = (b << lgf) * p + q0;
  const i64 slab = (i64)blockIdx.x << (lgf + LGQ);
  const Roots w = roots_table(wr, wi, lgf);

  // Phase 1: the n1-point FFT of every (q, j2), times w_f^(k1 j2).
  const int lgc1 = SL_LGM - lg1;
  for (int t0 = 0; t0 < (8 << lg2); t0 += 1 << lgc1)
    radix_fft<SL_T, SL_E>(Geo{lg1, lgc1, true}, w, xre, xim,
                          SlabRowColLoad{xr + in, xi + in, lgf, lg2, t0, cv},
                          SlabRowColStore{mr + slab, mi + slab, lgf, lg2, t0, cv, w});
  __syncthreads();  // the block's slab is complete and visible to it

  // Phase 2: the n2-point FFT of every (k1, q); bin k2 n1 + k1 of row q
  // through shared memory, consecutive threads on consecutive q.
  const int lgc2 = SL_LGM - lg2;
  const Geo g2{lg2, lgc2, false};
  const int lgp = pad_log2(lg2);
  for (int t0 = 0; t0 < (8 << lg1); t0 += 1 << lgc2) {
    radix_fft<SL_T, SL_E>(g2, w, xre, xim, SlabQLoad{mr + slab, mi + slab, lgf, lg2, t0, cv},
                          NoStore(), lgp);
#pragma unroll
    for (int e = 0; e < SL_E; ++e) {
      const int i = threadIdx.x + e * SL_T;
      const int sig = i & ((1 << lgc2) - 1);  // (k1 - t0 / 8, q)
      if ((sig & 7) >= cv) continue;
      const int k = ((i >> lgc2) << lg1) + ((t0 + sig) >> LGQ);
      const int a = oaddr(g2, lgp, sig, i >> lgc2);
      const i64 off = out + (i64)k * p + (sig & 7);
      yr[off] = xre[a] * scale;
      yi[off] = xim[a] * scale;
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

static bool grid_ok(i64 blocks) { return blocks >= 1 && blocks <= 0x7fffffff; }

static cudaError_t set_smem(const void* kernel, i64 smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int T, int E, int MB, bool NAT>
static cudaError_t cols_tile(i64 R, int lgf, i64 s, unsigned P, float scale, const void* wr,
                             const void* wi, const void* xr, const void* xi, const Twiddle& tw,
                             void* yr, void* yi, cudaStream_t st) {
  const int lgc = log2_exact(T * E) - lgf;
  const i64 chunks = (s + (1LL << lgc) - 1) >> lgc;
  if (lgc < 0 || !grid_ok(R * chunks)) return cudaErrorInvalidValue;
  const i64 smem = radix_smem_bytes(T * E);
  const cudaError_t err = set_smem((const void*)&cols_radix_kernel<T, E, MB, NAT>, smem);
  if (err != cudaSuccess) return err;
  cols_radix_kernel<T, E, MB, NAT><<<(unsigned)(R * chunks), T, (size_t)smem, st>>>(
      lgf, lgc, s, chunks, P, scale, (const float*)xr, (const float*)xi, (const float*)wr,
      (const float*)wi, tw, (float*)yr, (float*)yi);
  return cudaGetLastError();
}

template <int T, int E, int MB>
static cudaError_t rows_tile(i64 B, int lgf, i64 p, float scale, const void* wr, const void* wi,
                             const void* xr, const void* xi, void* yr, void* yi,
                             cudaStream_t st) {
  const int lgc = log2_exact(T * E) - lgf;
  const i64 chunks = (p + (1LL << lgc) - 1) >> lgc;
  if (lgc < 0 || !grid_ok(B * chunks)) return cudaErrorInvalidValue;
  const i64 smem = radix_smem_bytes(T * E);
  const cudaError_t err = set_smem((const void*)&rows_radix_kernel<T, E, MB>, smem);
  if (err != cudaSuccess) return err;
  rows_radix_kernel<T, E, MB><<<(unsigned)(B * chunks), T, (size_t)smem, st>>>(
      lgf, lgc, p, chunks, scale, (const float*)xr, (const float*)xi, (const float*)wr,
      (const float*)wi, (float*)yr, (float*)yi);
  return cudaGetLastError();
}

// The slab form's factors: 1024 <= f = n1 n2 with 8 <= n1, n2 <= 1024, so
// each phase's 8192-point tiles hold whole groups of 8 signals and cover
// the phase exactly.
static bool slab_ok(int lgf, int lg1) {
  return lgf >= 10 && lg1 >= 3 && lg1 <= 10 && lgf - lg1 >= 3 && lgf - lg1 <= 10;
}

// The column engine in the form `tile` names: log2 of the on-chip tile's
// points (12, 13, 14), or 0 for the four-step of factor n1 through the slab
// mr/mi (8 f points per block of 8 columns).
template <bool NAT>
static int cols_launch(i64 R, int lgf, i64 s, unsigned P, i64 n1, i64 tile, float scale,
                       const void* wr, const void* wi, const void* xr, const void* xi,
                       const Twiddle& tw, void* yr, void* yi, void* mr, void* mi,
                       cudaStream_t st) {
  if (tile == 12) return (int)cols_tile<T12, 4096 / T12, MB12, NAT>(R, lgf, s, P, scale, wr, wi, xr, xi, tw, yr, yi, st);
  if (tile == 13) return (int)cols_tile<T13, 8192 / T13, MB13, NAT>(R, lgf, s, P, scale, wr, wi, xr, xi, tw, yr, yi, st);
  if (tile == 14) return (int)cols_tile<T14, 16384 / T14, MB14, NAT>(R, lgf, s, P, scale, wr, wi, xr, xi, tw, yr, yi, st);
  const int lg1 = log2_exact(n1);
  const i64 chunks = (s + 7) >> LGQ;
  if (tile != 0 || mr == nullptr || !slab_ok(lgf, lg1) || !grid_ok(R * chunks))
    return (int)cudaErrorInvalidValue;
  const i64 smem = radix_smem_bytes(1 << SL_LGM);
  const cudaError_t err = set_smem((const void*)&cols_slab_kernel<NAT>, smem);
  if (err != cudaSuccess) return (int)err;
  cols_slab_kernel<NAT><<<(unsigned)(R * chunks), SL_T, (size_t)smem, st>>>(
      lgf, lg1, s, chunks, P, scale, (const float*)xr, (const float*)xi, (const float*)wr,
      (const float*)wi, tw, (float*)yr, (float*)yi, (float*)mr, (float*)mi);
  return (int)cudaGetLastError();
}

// wr/wi: the f f-th roots of the direction; inverse != 0 scales by 1/f;
// tr/ti: the (f, s / tw_every) twiddle grid or null; tile and n1 as
// cols_launch's.
extern "C" int repro_cols_pass(i64 R, i64 f, i64 s, i64 tw_every, i64 n1, i64 tile, i64 inverse,
                               const void* wr, const void* wi, const void* xr, const void* xi,
                               const void* tr, const void* ti, void* yr, void* yi, void* mr,
                               void* mi, void* stream) {
  const int lgf = log2_exact(f);
  if (R < 1 || lgf < 0 || lgf > 16 || s < 1 || s > 0x7fffffff || tw_every < 1 ||
      s % tw_every != 0)
    return (int)cudaErrorInvalidValue;
  const int lgw = log2_exact(tw_every);
  const Twiddle tw{(const float*)tr, (const float*)ti, lgw >= 0 ? s >> lgw : s / tw_every, lgw,
                   (int)tw_every};
  const float scale = inverse != 0 ? 1.f / (float)f : 1.f;
  return cols_launch<false>(R, lgf, s, 1, n1, tile, scale, wr, wi, xr, xi, tw, yr, yi, mr, mi,
                            (cudaStream_t)stream);
}

// As repro_cols_pass, for the (B, p, f) -> (B, f, p) row pass (f >= 2).
extern "C" int repro_rows_natural(i64 B, i64 p, i64 f, i64 n1, i64 tile, i64 inverse,
                                  const void* wr, const void* wi, const void* xr, const void* xi,
                                  void* yr, void* yi, void* mr, void* mi, void* stream) {
  const int lgf = log2_exact(f);
  if (B < 1 || p < 1 || lgf < 1 || lgf > 16) return (int)cudaErrorInvalidValue;
  const float scale = inverse != 0 ? 1.f / (float)f : 1.f;
  const cudaStream_t st = (cudaStream_t)stream;
  if (tile == 12) return (int)rows_tile<T12, 4096 / T12, MB12>(B, lgf, p, scale, wr, wi, xr, xi, yr, yi, st);
  if (tile == 13) return (int)rows_tile<T13, 8192 / T13, MB13>(B, lgf, p, scale, wr, wi, xr, xi, yr, yi, st);
  if (tile == 14) return (int)rows_tile<T14, 16384 / T14, MB14>(B, lgf, p, scale, wr, wi, xr, xi, yr, yi, st);
  const int lg1 = log2_exact(n1);
  const i64 chunks = (p + 7) >> LGQ;
  if (tile != 0 || mr == nullptr || !slab_ok(lgf, lg1) || !grid_ok(B * chunks))
    return (int)cudaErrorInvalidValue;
  const i64 smem = radix_smem_bytes(1 << SL_LGM);
  const cudaError_t err = set_smem((const void*)&rows_slab_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  rows_slab_kernel<<<(unsigned)(B * chunks), SL_T, (size_t)smem, st>>>(
      lgf, lg1, p, chunks, scale, (const float*)xr, (const float*)xi, (const float*)wr,
      (const float*)wi, (float*)yr, (float*)yi, (float*)mr, (float*)mi);
  return (int)cudaGetLastError();
}

// The (B, P, f, w) -> (B, f, P, w) column pass: cols_pass's engine over
// the (B P, f, w) view with no twiddle, each group's bins to its rows of
// the output (cols_out<true>); arguments as repro_cols_pass's.
extern "C" int repro_cols_natural(i64 B, i64 P, i64 f, i64 w, i64 n1, i64 tile, i64 inverse,
                                  const void* wr, const void* wi, const void* xr, const void* xi,
                                  void* yr, void* yi, void* mr, void* mi, void* stream) {
  const int lgf = log2_exact(f);
  if (B < 1 || B > 0x7fffffff || P < 1 || P > 0x7fffffff || lgf < 0 || lgf > 16 || w < 1 ||
      w > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const Twiddle none{nullptr, nullptr, 0, 0, 1};
  const float scale = inverse != 0 ? 1.f / (float)f : 1.f;
  return cols_launch<true>(B * P, lgf, w, (unsigned)P, n1, tile, scale, wr, wi, xr, xi, none, yr,
                           yi, mr, mi, (cudaStream_t)stream);
}

static const KernelEntry ATTRS[] = {
    {"cols_radix_kernel<256, 16>", (const void*)&cols_radix_kernel<T12, 4096 / T12, MB12, false>},
    {"cols_radix_kernel<512, 16>", (const void*)&cols_radix_kernel<T13, 8192 / T13, MB13, false>},
    {"cols_radix_kernel<1024, 16>", (const void*)&cols_radix_kernel<T14, 16384 / T14, MB14, false>},
    {"cols_slab_kernel", (const void*)&cols_slab_kernel<false>},
    {"cols_radix_kernel<256, 16, natural>", (const void*)&cols_radix_kernel<T12, 4096 / T12, MB12, true>},
    {"cols_radix_kernel<512, 16, natural>", (const void*)&cols_radix_kernel<T13, 8192 / T13, MB13, true>},
    {"cols_radix_kernel<1024, 16, natural>", (const void*)&cols_radix_kernel<T14, 16384 / T14, MB14, true>},
    {"cols_slab_kernel<natural>", (const void*)&cols_slab_kernel<true>},
    {"rows_radix_kernel<256, 16>", (const void*)&rows_radix_kernel<T12, 4096 / T12, MB12>},
    {"rows_radix_kernel<512, 16>", (const void*)&rows_radix_kernel<T13, 8192 / T13, MB13>},
    {"rows_radix_kernel<1024, 16>", (const void*)&rows_radix_kernel<T14, 16384 / T14, MB14>},
    {"rows_slab_kernel", (const void*)&rows_slab_kernel},
};

extern "C" int repro_attrs_pencil(int i, const char** name, i64* regs,
                                  i64* local) {
  return kernel_attributes(ATTRS, sizeof ATTRS / sizeof ATTRS[0], i, name, regs, local);
}
