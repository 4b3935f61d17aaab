// Shared block-level tile engines of the FFT pass kernels (sm_90a).
//
// Counterparts of the reference's in-VMEM tile functions:
//   cgemm_tile      <- cgemm_tile / dft_tile   (src/repro/kernels/fft4step.py:48,
//                                               src/repro/kernels/dft_matmul.py:39)
//   four_step_tile  <- four_step_tile          (src/repro/kernels/fft4step.py:57)
// The pencil kernels embed both, as pencil._tile_transform does.
//
// Every operand is a split-complex fp32 matrix *view*: a pair of plane
// pointers plus one strided index per axis (Ix below).  Views express the
// reference's reshapes, transposes and pencil strides as address arithmetic,
// so no layout change ever costs a pass over memory.
//
// cgemm_tile computes one BM x BN tile of O = A.B (optionally times a
// per-element phasor E) with a full-fp32 complex multiply-add on the CUDA
// cores: four FMAs per complex MAC, no TF32.  The reference's Karatsuba
// 3-GEMM form is a matrix-unit trick; with register blocking on CUDA cores
// the 4-FMA form needs fewer shared-memory loads per FMA and fewer registers
// and avoids Karatsuba's cancellation.  A K-stripe of each operand is staged
// through shared memory as interleaved float2; the loaders walk whichever
// axis of the operand has unit stride, and the thread -> output mapping
// walks whichever output axis has unit stride, so global loads and stores
// stay coalesced for row-major, column and transposed views alike.
//
// Load and store policies (template parameters whose defaults are the
// plain load and store) let a caller bend one GEMM without a runtime test
// in the shared tile: Bluestein's pre-chirp and zero pad on a load, its bin
// mask on a store, a column pass's twiddle column by division.  With the
// defaults every kernel compiles to the code it had without them.
//
// All offsets are 64-bit: B.n passes 2^31 at the main-path shapes.
#pragma once

#include <cuda_runtime.h>

namespace repro {

typedef long long i64;

// Strided index: element i sits at (i >> sh) * hi + (i & (2^sh - 1)) * lo.
// sh == 0 is a plain stride hi; sh > 0 splits i into a (high, low) pair of
// axes, e.g. (bin, signal-in-chunk).
struct Ix {
  int sh;
  i64 hi;
  i64 lo;
  __host__ __device__ __forceinline__ i64 operator()(i64 i) const {
    return (i >> sh) * hi + (i & ((1LL << sh) - 1)) * lo;
  }
  // Consecutive indices sit at consecutive addresses (within a low group).
  __host__ __device__ __forceinline__ bool unit() const {
    return sh > 0 ? lo == 1 : hi == 1;
  }
};

__host__ __device__ __forceinline__ Ix stride(i64 s) { return Ix{0, s, 0}; }

// Read-only complex matrix view: element (r, c) at re/im[row(r) + col(c)].
struct CMat {
  const float* re;
  const float* im;
  Ix row;
  Ix col;
};

// Output view, with an optional phasor E multiplied in before the store
// (er == nullptr: none).  E is indexed with its own view.
struct COut {
  float* re;
  float* im;
  Ix row;
  Ix col;
  const float* er;
  const float* ei;
  Ix erow;
  Ix ecol;
};

// The plain load: element (r, c) of the view as it is, into v.
struct PlainLoad {
  __device__ __forceinline__ void operator()(const CMat& X, int r, int c, float2& v) const {
    const i64 off = X.row(r) + X.col(c);
    v.x = X.re[off];
    v.y = X.im[off];
  }
};

// Bluestein's pre-chirp on a load.  Element (r, c) of the view is sample
// j = r * rmul + (c & cmask) of its signal: j >= n is the zero pad and
// reads nothing (v stays 0), else the sample times chirp[j].
struct ChirpLoad {
  const float* cr;
  const float* ci;
  int n;
  int rmul;
  int cmask;
  __device__ __forceinline__ void operator()(const CMat& X, int r, int c, float2& v) const {
    const int j = r * rmul + (c & cmask);
    if (j >= n) return;  // v stays 0
    const i64 off = X.row(r) + X.col(c);
    const float xr = X.re[off], xi = X.im[off];
    const float ar = cr[j], ai = ci[j];
    v.x = xr * ar - xi * ai;
    v.y = xr * ai + xi * ar;
  }
};

// The plain store: every element in range, the phasor at its own view.
struct PlainStore {
  __device__ __forceinline__ bool keep(int, int) const { return true; }
  __device__ __forceinline__ i64 eoff(const COut& O, int m, int c) const {
    return O.erow(m) + O.ecol(c);
  }
};

// Bluestein's bin mask on the natural-order store of a four-step GEMM 2:
// row m holds k1 = m mod n1, column c is k2, and only bins
// k = k2 * n1 + k1 < n are written.
struct BinMask {
  int n;
  int n1;
  __device__ __forceinline__ bool keep(int m, int c) const {
    return c * n1 + (m & (n1 - 1)) < n;
  }
  __device__ __forceinline__ i64 eoff(const COut& O, int m, int c) const {
    return O.erow(m) + O.ecol(c);
  }
};

// A column pass's twiddle column by division, for a width-broadcast run of
// w columns that is no power of two: column c of row m reads phasor
// m * ts + c / w (the shift view Ix serves a power-of-two w).
struct TwDiv {
  i64 ts;
  int w;
  __device__ __forceinline__ bool keep(int, int) const { return true; }
  __device__ __forceinline__ i64 eoff(const COut&, int m, int c) const {
    return (i64)m * ts + c / w;
  }
};

constexpr int BM = 64;          // output tile rows
constexpr int BN = 64;          // output tile columns
constexpr int BK = 16;          // K-stripe depth
constexpr int THREADS = 256;    // one block = 16 x 16 threads
constexpr int TM = BM / 16;     // micro-tile rows per thread
constexpr int TN = BN / 16;     // micro-tile columns per thread
constexpr int LDS = BM + 1;     // padded staging row (float2 units)
// Shared memory of the staging tiles A[BK][LDS] and B[BK][LDS].
constexpr int TILE_SMEM_BYTES = 2 * BK * LDS * (int)sizeof(float2);

__host__ __device__ __forceinline__ int cdiv(i64 a, int b) { return (int)((a + b - 1) / b); }

// One BM x BN tile (rows m0.., columns n0..) of O = A.B (.* E), A: M x K,
// B: K x N.  Called by all THREADS threads of the block; smem holds
// TILE_SMEM_BYTES.  Edges are masked, so any M, N, K >= 1 work.  la / lb
// read A / B, st masks and places the store (see the policies above).
template <class LA = PlainLoad, class LB = PlainLoad, class ST = PlainStore>
__device__ __forceinline__ void cgemm_tile(int M, int N, int K, int m0, int n0,
                                           const CMat& A, const CMat& B,
                                           const COut& O, float2* smem,
                                           const LA& la = LA(),
                                           const LB& lb = LB(),
                                           const ST& st = ST()) {
  float2* As = smem;             // As[k * LDS + m]
  float2* Bs = smem + BK * LDS;  // Bs[k * LDS + n]
  const int tid = threadIdx.x;
  // Consecutive threads walk the output axis with unit stride.
  const bool mfast = !O.col.unit() && O.row.unit();
  const int tm = mfast ? (tid & 15) : (tid >> 4);
  const int tn = mfast ? (tid >> 4) : (tid & 15);
  const bool a_mfast = A.row.unit();
  const bool b_nfast = B.col.unit();

  float accr[TM][TN];
  float acci[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      accr[i][j] = 0.f;
      acci[i][j] = 0.f;
    }

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int r = 0; r < (BM * BK) / THREADS; ++r) {
      const int e = tid + r * THREADS;
      const int m = a_mfast ? (e % BM) : (e / BK);
      const int k = a_mfast ? (e / BM) : (e % BK);
      const int gm = m0 + m, gk = k0 + k;
      float2 v = make_float2(0.f, 0.f);
      if (gm < M && gk < K) la(A, gm, gk, v);
      As[k * LDS + m] = v;
    }
#pragma unroll
    for (int r = 0; r < (BN * BK) / THREADS; ++r) {
      const int e = tid + r * THREADS;
      const int n = b_nfast ? (e % BN) : (e / BK);
      const int k = b_nfast ? (e / BN) : (e % BK);
      const int gn = n0 + n, gk = k0 + k;
      float2 v = make_float2(0.f, 0.f);
      if (gn < N && gk < K) lb(B, gk, gn, v);
      Bs[k * LDS + n] = v;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float2 a[TM];
      float2 b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[k * LDS + tm + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[k * LDS + tn + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          accr[i][j] = fmaf(a[i].x, b[j].x, accr[i][j]);
          accr[i][j] = fmaf(-a[i].y, b[j].y, accr[i][j]);
          acci[i][j] = fmaf(a[i].x, b[j].y, acci[i][j]);
          acci[i][j] = fmaf(a[i].y, b[j].x, acci[i][j]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gm = m0 + tm + 16 * i;
      const int gn = n0 + tn + 16 * j;
      if (gm < M && gn < N && st.keep(gm, gn)) {
        float yr = accr[i][j];
        float yi = acci[i][j];
        if (O.er != nullptr) {
          const i64 eo = st.eoff(O, gm, gn);
          const float er = O.er[eo], ei = O.ei[eo];
          const float t = yr * er - yi * ei;
          yi = yr * ei + yi * er;
          yr = t;
        }
        const i64 oo = O.row(gm) + O.col(gn);
        O.re[oo] = yr;
        O.im[oo] = yi;
      }
    }
}

// The whole M x N product, tile by tile, by one block.
template <class LA = PlainLoad, class LB = PlainLoad, class ST = PlainStore>
__device__ __forceinline__ void cgemm_block(int M, int N, int K, const CMat& A,
                                            const CMat& B, const COut& O,
                                            float2* smem, const LA& la = LA(),
                                            const LB& lb = LB(),
                                            const ST& st = ST()) {
  const int tn = cdiv(N, BN);
  const int tiles = cdiv(M, BM) * tn;
  for (int t = 0; t < tiles; ++t)
    cgemm_tile(M, N, K, (t / tn) * BM, (t % tn) * BN, A, B, O, smem, la, lb, st);
}

// A chunk of C signals in memory: signal c, element j at
// re/im[c * sc + j * sj].
struct Sig {
  const float* re;
  const float* im;
  i64 sc;
  i64 sj;
};

// Where a chunk's transforms go: signal c, bin k at re/im[c * sc + k * sk],
// times the phasor er/ei[c * esc + k * esk] when er != nullptr.
struct SigOut {
  float* re;
  float* im;
  i64 sc;
  i64 sk;
  const float* er;
  const float* ei;
  i64 esc;
  i64 esk;
};

// Shared memory one four_step_tile needs when its intermediate lives there.
__host__ __device__ __forceinline__ i64 four_step_smem_bytes(i64 n, int lgc) {
  return TILE_SMEM_BYTES + 2 * (n << lgc) * (i64)sizeof(float);
}

// Four-step FFT of a chunk of C = 2^lgc signals of length n = n1 * n2 by one
// block:  A = W1 . X  (column DFTs),  B = A .* T,  C = B . W2  (row DFTs),
// written in natural order (bin k2*n1 + k1) or k1-major (bin k1*n2 + k2).
// The reference's  (bt, n) -> (n1, bt*n2)  relayout is the view of GEMM 1's
// N axis: q = (j2, c) pairs.  The intermediate B (n1 x n2 x C complex) lives
// at mid_re/mid_im: shared memory when it fits the block, else a global
// scratch slab of the same size owned by this block.  LUTs: W1 (n1 x n1),
// T (n1 x n2), W2 (n2 x n2), row-major; inverse scaling is folded in W2.
// l1 reads the signals into GEMM 1 and s2 masks GEMM 2's store; j1_end > 0
// stops GEMM 1 at input rows j1 < j1_end and k2_end > 0 GEMM 2 at bins
// k2 < k2_end (Bluestein's zero pad and sliced bins); both whole by default.
template <class L1 = PlainLoad, class S2 = PlainStore>
__device__ __forceinline__ void four_step_tile(
    int n1, int lg1, int n2, int lg2, int lgc, const float* w1r,
    const float* w1i, const float* tr, const float* ti, const float* w2r,
    const float* w2i, const Sig& x, const SigOut& y, bool natural,
    float* mid_re, float* mid_im, float2* smem, const L1& l1 = L1(),
    const S2& s2 = S2(), int j1_end = 0, int k2_end = 0) {
  const int C = 1 << lgc;
  const i64 n2c = (i64)n2 << lgc;
  // GEMM 1: mid[k1, q] = sum_j1 W1[k1, j1] x[c, j1*n2 + j2] * T[k1, j2].
  // q orders (j2, c) with c fastest when the signals are the input's unit
  // axis (column chunks), else with j2 fastest (row chunks).
  const bool c_lo = x.sc == 1 && C > 1;
  const Ix q_in = c_lo ? Ix{lgc, x.sj, x.sc} : Ix{lg2, x.sc, x.sj};
  const Ix q_tw = c_lo ? Ix{lgc, 1, 0} : Ix{lg2, 0, 1};
  const CMat A1{w1r, w1i, stride(n1), stride(1)};
  const CMat B1{x.re, x.im, stride((i64)n2 * x.sj), q_in};
  const COut O1{mid_re, mid_im, stride(n2c), stride(1),
                tr,     ti,     stride(n2),  q_tw};
  cgemm_block(n1, (int)n2c, j1_end > 0 ? j1_end : n1, A1, B1, O1, smem, PlainLoad(), l1);
  __syncthreads();  // the intermediate is complete and visible to the block

  // GEMM 2: y[c, bin(k1, k2)] = sum_j2 mid[k1, q(j2, c)] W2[j2, k2].
  // Row m is the (k1, c) pair, c fastest when the output's signals are its
  // unit axis, else k1 fastest.
  const i64 mid_c = c_lo ? 1 : n2;
  const i64 mid_j2 = c_lo ? C : 1;
  const i64 out_k1 = natural ? y.sk : (i64)n2 * y.sk;
  const i64 out_k2 = natural ? (i64)n1 * y.sk : y.sk;
  const i64 e_k1 = natural ? y.esk : (i64)n2 * y.esk;
  const i64 e_k2 = natural ? (i64)n1 * y.esk : y.esk;
  const bool yc_lo = y.sc == 1 && C > 1;
  const Ix m_mid = yc_lo ? Ix{lgc, n2c, mid_c} : Ix{lg1, mid_c, n2c};
  const Ix m_out = yc_lo ? Ix{lgc, out_k1, y.sc} : Ix{lg1, y.sc, out_k1};
  const Ix m_e = yc_lo ? Ix{lgc, e_k1, y.esc} : Ix{lg1, y.esc, e_k1};
  const CMat A2{mid_re, mid_im, m_mid, stride(mid_j2)};
  const CMat B2{w2r, w2i, stride(n2), stride(1)};
  const COut O2{y.re, y.im, m_out, stride(out_k2),
                y.er, y.ei, m_e,   stride(e_k2)};
  cgemm_block(n1 << lgc, k2_end > 0 ? k2_end : n2, n2, A2, B2, O2, smem, PlainLoad(),
              PlainLoad(), s2);
}

// Compiled attributes of the kernels of one source, for the register guard
// of chip_smoke.py: entry i of its table gives the kernel's name, its
// registers per thread and its local (spill) bytes per thread.  Returns -1
// past the table's end, else the cudaError_t of the query.
struct KernelEntry {
  const char* name;
  const void* fn;
};

inline int kernel_attributes(const KernelEntry* table, int count, int i,
                             const char** name, i64* regs, i64* local) {
  if (i < 0 || i >= count) return -1;
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, table[i].fn);
  if (err != cudaSuccess) return (int)err;
  *name = table[i].name;
  *regs = a.numRegs;
  *local = (i64)a.localSizeBytes;
  return 0;
}

}  // namespace repro
