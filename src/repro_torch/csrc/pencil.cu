// Pass kernels of the split regime (n > 65536): two HBM round trips cover
// every n <= 2^32.
//
// cols_pass  replaces cols_pass_call (src/repro/kernels/pencil.py:102,
//            pallas_call at :149): on an (R, f, s) view, a length-f
//            transform down the middle axis of every column, times the
//            inter-factor twiddle T[k, c] (an (f, s) LUT, streamed once).
// rows_natural replaces rows_natural_call (src/repro/kernels/pencil.py:178,
//            pallas_call at :203): on a (B, p, f) view, a length-f transform
//            of every row, written transposed to (B, f, p) so the program's
//            output lands in natural order with no transpose pass.
//
// Each embeds the shared tile engines (tile.cuh) as pencil._tile_transform
// does: the direct DFT for f <= 1024, the four-step tile beyond.  Loads and
// stores run along the contiguous axis: s for the columns, the output's p
// for the transposed rows.  The direct form is one complex GEMM per view
// (Y[r] = W^T . X[r], resp. Y[b] = W^T . X[b]^T) tiled 64 x 64 over the
// grid; the four-step form gives each block a chunk of C = 2^lgc adjacent
// columns (rows) — 8 floats = one 32-byte sector per plane — so the strided
// reads of the columns use whole sectors.
//
// Bound on the H100: arithmetic, as the leaves (the work needs 6.f or
// 6.(n1 + n2) flops per element over 16 bytes, plus 8 bytes of twiddle for
// the columns; the tiles spend 8 per complex multiply-add).
// The four-step intermediate of a chunk lives in shared memory when it fits
// (f.C <= 16384) and in a wrapper-owned global scratch slab otherwise (see
// fft4step.cu for the extra bytes).
#include "tile.cuh"

using namespace repro;

__global__ void __launch_bounds__(THREADS)
    cols_direct_kernel(int f, i64 s, const float* wr, const float* wi,
                       const float* xr, const float* xi, const float* tr,
                       const float* ti, float* yr, float* yi) {
  __shared__ float2 smem[2 * BK * LDS];
  const int tm = cdiv(f, BM), tn = cdiv(s, BN);
  const i64 per_r = (i64)tm * tn;
  const i64 r = blockIdx.x / per_r;
  const int t = (int)(blockIdx.x % per_r);
  const i64 base = r * f * s;
  const CMat Wt{wr, wi, stride(1), stride(f)};  // Wt[k, j] = W[j, k]
  const CMat X{xr + base, xi + base, stride(s), stride(1)};
  const COut Y{yr + base, yi + base, stride(s), stride(1),
               tr,        ti,        stride(s), stride(1)};
  cgemm_tile(f, (int)s, f, (t / tn) * BM, (t % tn) * BN, Wt, X, Y, smem);
}

__global__ void __launch_bounds__(THREADS)
    cols_fused_kernel(int n1, int lg1, int n2, int lg2, int lgc, i64 s,
                      const float* w1r, const float* w1i, const float* t4r,
                      const float* t4i, const float* w2r, const float* w2i,
                      const float* xr, const float* xi, const float* tr,
                      const float* ti, float* yr, float* yi, float* scr_re,
                      float* scr_im) {
  extern __shared__ float2 smem[];
  const i64 f = (i64)n1 * n2;
  const i64 chunks = s >> lgc;
  const i64 r = blockIdx.x / chunks;
  const i64 c0 = (blockIdx.x % chunks) << lgc;
  const i64 base = r * f * s + c0;
  const Sig x{xr + base, xi + base, 1, s};
  const SigOut y{yr + base, yi + base, 1, s,
                 tr != nullptr ? tr + c0 : nullptr,
                 ti != nullptr ? ti + c0 : nullptr, 1, s};
  float* mid_re;
  float* mid_im;
  if (scr_re != nullptr) {
    mid_re = scr_re + (i64)blockIdx.x * (f << lgc);
    mid_im = scr_im + (i64)blockIdx.x * (f << lgc);
  } else {
    mid_re = reinterpret_cast<float*>(smem + 2 * BK * LDS);
    mid_im = mid_re + (f << lgc);
  }
  four_step_tile(n1, lg1, n2, lg2, lgc, w1r, w1i, t4r, t4i, w2r, w2i, x, y,
                 true, mid_re, mid_im, smem);
}

__global__ void __launch_bounds__(THREADS)
    rows_direct_kernel(int f, i64 p, const float* wr, const float* wi,
                       const float* xr, const float* xi, float* yr, float* yi) {
  __shared__ float2 smem[2 * BK * LDS];
  const int tm = cdiv(f, BM), tn = cdiv(p, BN);
  const i64 per_b = (i64)tm * tn;
  const i64 b = blockIdx.x / per_b;
  const int t = (int)(blockIdx.x % per_b);
  const i64 base = b * p * f;
  const CMat Wt{wr, wi, stride(1), stride(f)};            // Wt[k, j] = W[j, k]
  const CMat Xt{xr + base, xi + base, stride(1), stride(f)};  // Xt[j, q] = x[q, j]
  const COut Y{yr + base, yi + base, stride(p), stride(1),
               nullptr,   nullptr,   stride(0), stride(0)};
  cgemm_tile(f, (int)p, f, (t / tn) * BM, (t % tn) * BN, Wt, Xt, Y, smem);
}

__global__ void __launch_bounds__(THREADS)
    rows_fused_kernel(int n1, int lg1, int n2, int lg2, int lgc, i64 p,
                      const float* w1r, const float* w1i, const float* t4r,
                      const float* t4i, const float* w2r, const float* w2i,
                      const float* xr, const float* xi, float* yr, float* yi,
                      float* scr_re, float* scr_im) {
  extern __shared__ float2 smem[];
  const i64 f = (i64)n1 * n2;
  const i64 chunks = p >> lgc;
  const i64 b = blockIdx.x / chunks;
  const i64 q0 = (blockIdx.x % chunks) << lgc;
  const i64 in_base = b * p * f + q0 * f;
  const i64 out_base = b * f * p + q0;
  const Sig x{xr + in_base, xi + in_base, f, 1};
  const SigOut y{yr + out_base, yi + out_base, 1, p, nullptr, nullptr, 0, 0};
  float* mid_re;
  float* mid_im;
  if (scr_re != nullptr) {
    mid_re = scr_re + (i64)blockIdx.x * (f << lgc);
    mid_im = scr_im + (i64)blockIdx.x * (f << lgc);
  } else {
    mid_re = reinterpret_cast<float*>(smem + 2 * BK * LDS);
    mid_im = mid_re + (f << lgc);
  }
  four_step_tile(n1, lg1, n2, lg2, lgc, w1r, w1i, t4r, t4i, w2r, w2i, x, y,
                 true, mid_re, mid_im, smem);
}

static int log2_exact(i64 v) {
  int lg = 0;
  while ((1LL << lg) < v) ++lg;
  return (1LL << lg) == v ? lg : -1;
}

static bool grid_ok(i64 blocks) { return blocks >= 1 && blocks <= 0x7fffffff; }

static cudaError_t set_smem(const void* kernel, i64 smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

extern "C" int repro_cols_pass_direct(i64 R, i64 f, i64 s, const void* wr,
                                      const void* wi, const void* xr,
                                      const void* xi, const void* tr,
                                      const void* ti, void* yr, void* yi,
                                      void* stream) {
  const i64 blocks = R * cdiv(f, BM) * cdiv(s, BN);
  if (f < 1 || f > 0x7fffffff || s > 0x7fffffff || !grid_ok(blocks))
    return (int)cudaErrorInvalidValue;
  cols_direct_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (int)f, s, (const float*)wr, (const float*)wi, (const float*)xr,
      (const float*)xi, (const float*)tr, (const float*)ti, (float*)yr,
      (float*)yi);
  return (int)cudaGetLastError();
}

extern "C" int repro_cols_pass_fused(i64 R, i64 n1, i64 n2, i64 s, i64 lgc,
                                     const void* w1r, const void* w1i,
                                     const void* t4r, const void* t4i,
                                     const void* w2r, const void* w2i,
                                     const void* xr, const void* xi,
                                     const void* tr, const void* ti, void* yr,
                                     void* yi, void* scr_re, void* scr_im,
                                     void* stream) {
  const int lg1 = log2_exact(n1), lg2 = log2_exact(n2);
  if (lg1 < 0 || lg2 < 0 || lgc < 0 || s % (1LL << lgc) != 0)
    return (int)cudaErrorInvalidValue;
  const i64 blocks = R * (s >> lgc);
  if (!grid_ok(blocks)) return (int)cudaErrorInvalidValue;
  const i64 smem =
      scr_re != nullptr ? TILE_SMEM_BYTES : four_step_smem_bytes(n1 * n2, (int)lgc);
  cudaError_t err = set_smem((const void*)cols_fused_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cols_fused_kernel<<<(unsigned)blocks, THREADS, (size_t)smem, (cudaStream_t)stream>>>(
      (int)n1, lg1, (int)n2, lg2, (int)lgc, s, (const float*)w1r,
      (const float*)w1i, (const float*)t4r, (const float*)t4i,
      (const float*)w2r, (const float*)w2i, (const float*)xr, (const float*)xi,
      (const float*)tr, (const float*)ti, (float*)yr, (float*)yi,
      (float*)scr_re, (float*)scr_im);
  return (int)cudaGetLastError();
}

extern "C" int repro_rows_natural_direct(i64 B, i64 p, i64 f, const void* wr,
                                         const void* wi, const void* xr,
                                         const void* xi, void* yr, void* yi,
                                         void* stream) {
  const i64 blocks = B * cdiv(f, BM) * cdiv(p, BN);
  if (f < 1 || f > 0x7fffffff || p > 0x7fffffff || !grid_ok(blocks))
    return (int)cudaErrorInvalidValue;
  rows_direct_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (int)f, p, (const float*)wr, (const float*)wi, (const float*)xr,
      (const float*)xi, (float*)yr, (float*)yi);
  return (int)cudaGetLastError();
}

extern "C" int repro_rows_natural_fused(i64 B, i64 p, i64 n1, i64 n2, i64 lgc,
                                        const void* w1r, const void* w1i,
                                        const void* t4r, const void* t4i,
                                        const void* w2r, const void* w2i,
                                        const void* xr, const void* xi,
                                        void* yr, void* yi, void* scr_re,
                                        void* scr_im, void* stream) {
  const int lg1 = log2_exact(n1), lg2 = log2_exact(n2);
  if (lg1 < 0 || lg2 < 0 || lgc < 0 || p % (1LL << lgc) != 0)
    return (int)cudaErrorInvalidValue;
  const i64 blocks = B * (p >> lgc);
  if (!grid_ok(blocks)) return (int)cudaErrorInvalidValue;
  const i64 smem =
      scr_re != nullptr ? TILE_SMEM_BYTES : four_step_smem_bytes(n1 * n2, (int)lgc);
  cudaError_t err = set_smem((const void*)rows_fused_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  rows_fused_kernel<<<(unsigned)blocks, THREADS, (size_t)smem, (cudaStream_t)stream>>>(
      (int)n1, lg1, (int)n2, lg2, (int)lgc, p, (const float*)w1r,
      (const float*)w1i, (const float*)t4r, (const float*)t4i,
      (const float*)w2r, (const float*)w2i, (const float*)xr, (const float*)xi,
      (float*)yr, (float*)yi, (float*)scr_re, (float*)scr_im);
  return (int)cudaGetLastError();
}
