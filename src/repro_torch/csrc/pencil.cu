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
//            width.  A power-of-two w is a shift (c >> log2 w); any other
//            w divides, per element in the direct form (the TwDiv store
//            policy) and once per tile in the four-step form, whose chunk
//            of columns then divides w so it never straddles two runs.  s need not be a multiple of the chunk: the
//            ragged last chunk transforms its columns one at a time (an
//            rfft2 half-spectrum is m + 1 columns wide), with no padded
//            copy.
// cols_natural replaces cols_natural_call (src/repro/kernels/pencil.py:234,
//            pallas_call at :265): on a (B, P, f, w) view, a length-f
//            transform down axis 2, written as (B, f, P, w) -- the n2-axis
//            digit transpose of a strip-mined column program fused into the
//            write.  The same kernels as cols_pass with the output view
//            changed: column group r = (b, p) writes rows of stride P.w at
//            offset p.w of pencil b; P = 1 is cols_pass's in-place layout.
// rows_natural replaces rows_natural_call (src/repro/kernels/pencil.py:178,
//            pallas_call at :203): on a (B, p, f) view, a length-f transform
//            of every row, written transposed to (B, f, p) so the program's
//            output lands in natural order with no transpose pass.
//
// Each embeds the shared tile engines (tile.cuh) as pencil._tile_transform
// does: the direct DFT for f <= 1024, the four-step tile beyond.  Loads and
// stores run along the contiguous axis: s (w) for the columns, the output's
// p for the transposed rows.  The direct form is one complex GEMM per view
// (Y[r] = W^T . X[r], resp. Y[b] = W^T . X[b]^T) tiled 64 x 64 over the
// grid; the four-step form gives each block a chunk of C = 2^lgc adjacent
// columns (rows) -- 8 floats = one 32-byte sector per plane -- so the
// strided reads of the columns use whole sectors.
//
// Bound on the H100: arithmetic, as the leaves (the work needs 6.f or
// 6.(n1 + n2) flops per element over 16 bytes, plus 8 bytes of twiddle for
// the columns; the tiles spend 8 per complex multiply-add).
// The four-step intermediate of a chunk lives in shared memory when it fits
// (f.C <= 16384) and in a wrapper-owned global scratch slab otherwise (see
// fft4step.cu for the extra bytes).
#include "tile.cuh"

using namespace repro;

// Offset of column group r's output: pencil r / P, digit r % P (P = 1: the
// input's own layout).
__device__ __forceinline__ i64 cols_out_base(i64 r, i64 P, i64 f, i64 s) {
  return (r / P) * f * P * s + (r % P) * s;
}

// ST: PlainStore reads the twiddle through the shift view (power-of-two
// tw_every, lgw its log2), TwDiv by division (any other tw_every).
template <class ST>
__global__ void __launch_bounds__(THREADS)
    cols_direct_kernel(int f, i64 s, i64 P, int lgw, ST st, const float* wr,
                       const float* wi, const float* xr, const float* xi,
                       const float* tr, const float* ti, float* yr,
                       float* yi) {
  __shared__ float2 smem[2 * BK * LDS];
  const int tm = cdiv(f, BM), tn = cdiv(s, BN);
  const i64 per_r = (i64)tm * tn;
  const i64 r = blockIdx.x / per_r;
  const int t = (int)(blockIdx.x % per_r);
  const i64 base = r * f * s;
  const i64 ob = cols_out_base(r, P, f, s);
  const CMat Wt{wr, wi, stride(1), stride(f)};  // Wt[k, j] = W[j, k]
  const CMat X{xr + base, xi + base, stride(s), stride(1)};
  // Twiddle T[k, c >> lgw] of the (f, s >> lgw) grid.
  const COut Y{yr + ob, yi + ob, stride(P * s),      stride(1),
               tr,      ti,      stride(s >> lgw), Ix{lgw, 1, 0}};
  cgemm_tile(f, (int)s, f, (t / tn) * BM, (t % tn) * BN, Wt, X, Y, smem,
             PlainLoad(), PlainLoad(), st);
}

// Launched with THREADS threads; the bound of 2 * THREADS holds ptxas to
// 128 registers, so two blocks fit an SM.  Bounded by THREADS alone it took
// 186 (one block per SM), and the column passes whose intermediate sits in
// the scratch slab ran 1.6-1.8x slower on the H100 (PERF.md).  DIV: the
// twiddle column of a tile is c / w (tw_every = w no power of two), else
// c >> lgw.
template <bool DIV>
__global__ void __launch_bounds__(2 * THREADS)
    cols_fused_kernel(int n1, int lg1, int n2, int lg2, int lgc, i64 s, i64 P,
                      int lgw, i64 w, const float* w1r, const float* w1i,
                      const float* t4r, const float* t4i, const float* w2r,
                      const float* w2i, const float* xr, const float* xi,
                      const float* tr, const float* ti, float* yr, float* yi,
                      float* scr_re, float* scr_im) {
  extern __shared__ float2 smem[];
  const i64 f = (i64)n1 * n2;
  const i64 C = 1LL << lgc;
  const i64 chunks = (s + C - 1) >> lgc;
  const i64 r = blockIdx.x / chunks;
  const i64 c0 = (blockIdx.x % chunks) << lgc;
  float* mid_re;
  float* mid_im;
  if (scr_re != nullptr) {
    mid_re = scr_re + (i64)blockIdx.x * (f << lgc);
    mid_im = scr_im + (i64)blockIdx.x * (f << lgc);
  } else {
    mid_re = reinterpret_cast<float*>(smem + 2 * BK * LDS);
    mid_im = mid_re + (f << lgc);
  }
  // A whole chunk is one tile of C columns.  The ragged last chunk of a
  // width that is no multiple of C (rfft2's m + 1 bins) takes its nc < C
  // columns one at a time instead, so no load or store needs a mask.
  const i64 nc = s - c0 < C ? s - c0 : C;
  const int lgt = nc == C ? lgc : 0;
  const i64 tiles = nc == C ? 1 : nc;
  for (i64 t = 0; t < tiles; ++t) {
    const i64 c = c0 + t;
    const i64 base = r * f * s + c;
    const i64 ob = cols_out_base(r, P, f, s) + c;
    const Sig x{xr + base, xi + base, 1, s};
    // A tile lies inside one run of w columns (2^lgc divides w when
    // w > 1), so with w > 1 all its columns share twiddle column c / w.
    // (32-bit: the division variant takes s < 2^31.)
    const i64 tc = DIV ? (i64)((int)c / (int)w) : c >> lgw;
    const SigOut y{yr + ob, yi + ob, 1, P * s,
                   tr != nullptr ? tr + tc : nullptr,
                   ti != nullptr ? ti + tc : nullptr,
                   DIV ? 0 : (lgw == 0 ? 1 : 0), DIV ? (i64)((int)s / (int)w) : s >> lgw};
    four_step_tile(n1, lg1, n2, lg2, lgt, w1r, w1i, t4r, t4i, w2r, w2i, x, y,
                   true, mid_re, mid_im, smem);
    __syncthreads();  // the next tile reuses the staging and the intermediate
  }
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

static cudaError_t cols_direct(i64 R, i64 P, i64 f, i64 s, i64 w,
                               const void* wr, const void* wi, const void* xr,
                               const void* xi, const void* tr, const void* ti,
                               void* yr, void* yi, void* stream) {
  const i64 blocks = R * cdiv(f, BM) * cdiv(s, BN);
  if (f < 1 || f > 0x7fffffff || s < 1 || s > 0x7fffffff || P < 1 ||
      R % P != 0 || w < 1 || s % w != 0 || !grid_ok(blocks))
    return cudaErrorInvalidValue;
  const int lgw = log2_exact(w);
  if (lgw >= 0)
    cols_direct_kernel<PlainStore><<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (int)f, s, P, lgw, PlainStore(), (const float*)wr, (const float*)wi,
        (const float*)xr, (const float*)xi, (const float*)tr, (const float*)ti,
        (float*)yr, (float*)yi);
  else
    cols_direct_kernel<TwDiv><<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (int)f, s, P, 0, TwDiv{s / w, (int)w}, (const float*)wr, (const float*)wi,
        (const float*)xr, (const float*)xi, (const float*)tr, (const float*)ti,
        (float*)yr, (float*)yi);
  return cudaGetLastError();
}


template <bool DIV>
static cudaError_t cols_fused_launch(i64 blocks, i64 smem, int lg1, int lg2,
                                     i64 n1, i64 n2, i64 lgc, i64 s, i64 P,
                                     int lgw, i64 w, const void* w1r,
                                     const void* w1i, const void* t4r,
                                     const void* t4i, const void* w2r,
                                     const void* w2i, const void* xr,
                                     const void* xi, const void* tr,
                                     const void* ti, void* yr, void* yi,
                                     void* scr_re, void* scr_im, void* stream) {
  cudaError_t err = set_smem((const void*)&cols_fused_kernel<DIV>, smem);
  if (err != cudaSuccess) return err;
  cols_fused_kernel<DIV><<<(unsigned)blocks, THREADS, (size_t)smem, (cudaStream_t)stream>>>(
      (int)n1, lg1, (int)n2, lg2, (int)lgc, s, P, lgw, w, (const float*)w1r,
      (const float*)w1i, (const float*)t4r, (const float*)t4i,
      (const float*)w2r, (const float*)w2i, (const float*)xr, (const float*)xi,
      (const float*)tr, (const float*)ti, (float*)yr, (float*)yi,
      (float*)scr_re, (float*)scr_im);
  return cudaGetLastError();
}

static cudaError_t cols_fused(i64 R, i64 P, i64 n1, i64 n2, i64 s, i64 lgc,
                              i64 w, const void* w1r, const void* w1i,
                              const void* t4r, const void* t4i,
                              const void* w2r, const void* w2i,
                              const void* xr, const void* xi, const void* tr,
                              const void* ti, void* yr, void* yi,
                              void* scr_re, void* scr_im, void* stream) {
  const int lg1 = log2_exact(n1), lg2 = log2_exact(n2);
  if (lg1 < 0 || lg2 < 0 || lgc < 0 || s < 1 || P < 1 || R % P != 0 ||
      w < 1 || s % w != 0 || (w > 1 && w % (1LL << lgc) != 0) ||
      (log2_exact(w) < 0 && s > 0x7fffffff))
    return cudaErrorInvalidValue;
  // One block per chunk of 2^lgc columns, the last one of each group ragged
  // when s is no multiple of it; the scratch slab holds n1.n2.2^lgc floats
  // per block and plane.
  const i64 blocks = R * ((s + (1LL << lgc) - 1) >> lgc);
  if (!grid_ok(blocks)) return cudaErrorInvalidValue;
  const i64 smem =
      scr_re != nullptr ? TILE_SMEM_BYTES : four_step_smem_bytes(n1 * n2, (int)lgc);
  const int lgw = log2_exact(w);
  if (lgw >= 0)
    return cols_fused_launch<false>(blocks, smem, lg1, lg2, n1, n2, lgc, s, P,
                                    lgw, w, w1r, w1i, t4r, t4i, w2r, w2i, xr,
                                    xi, tr, ti, yr, yi, scr_re, scr_im, stream);
  return cols_fused_launch<true>(blocks, smem, lg1, lg2, n1, n2, lgc, s, P, 0,
                                 w, w1r, w1i, t4r, t4i, w2r, w2i, xr, xi, tr,
                                 ti, yr, yi, scr_re, scr_im, stream);
}

extern "C" int repro_cols_pass_direct(i64 R, i64 f, i64 s, i64 tw_every,
                                      const void* wr, const void* wi,
                                      const void* xr, const void* xi,
                                      const void* tr, const void* ti, void* yr,
                                      void* yi, void* stream) {
  return (int)cols_direct(R, 1, f, s, tw_every, wr, wi, xr, xi, tr, ti, yr, yi,
                          stream);
}

extern "C" int repro_cols_pass_fused(i64 R, i64 n1, i64 n2, i64 s, i64 lgc,
                                     i64 tw_every, const void* w1r,
                                     const void* w1i,
                                     const void* t4r, const void* t4i,
                                     const void* w2r, const void* w2i,
                                     const void* xr, const void* xi,
                                     const void* tr, const void* ti, void* yr,
                                     void* yi, void* scr_re, void* scr_im,
                                     void* stream) {
  return (int)cols_fused(R, 1, n1, n2, s, lgc, tw_every, w1r, w1i, t4r, t4i,
                         w2r, w2i, xr, xi, tr, ti, yr, yi, scr_re, scr_im,
                         stream);
}

extern "C" int repro_cols_natural_direct(i64 B, i64 P, i64 f, i64 w,
                                         const void* wr, const void* wi,
                                         const void* xr, const void* xi,
                                         void* yr, void* yi, void* stream) {
  return (int)cols_direct(B * P, P, f, w, 1, wr, wi, xr, xi, nullptr, nullptr,
                          yr, yi, stream);
}

extern "C" int repro_cols_natural_fused(i64 B, i64 P, i64 n1, i64 n2, i64 w,
                                        i64 lgc, const void* w1r,
                                        const void* w1i, const void* t4r,
                                        const void* t4i, const void* w2r,
                                        const void* w2i, const void* xr,
                                        const void* xi, void* yr, void* yi,
                                        void* scr_re, void* scr_im,
                                        void* stream) {
  return (int)cols_fused(B * P, P, n1, n2, w, lgc, 1, w1r, w1i, t4r, t4i, w2r,
                         w2i, xr, xi, nullptr, nullptr, yr, yi, scr_re,
                         scr_im, stream);
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

static const KernelEntry ATTRS[] = {
    {"cols_direct_kernel", (const void*)&cols_direct_kernel<PlainStore>},
    {"cols_direct_kernel<TwDiv>", (const void*)&cols_direct_kernel<TwDiv>},
    {"cols_fused_kernel", (const void*)&cols_fused_kernel<false>},
    {"cols_fused_kernel<DIV>", (const void*)&cols_fused_kernel<true>},
    {"rows_direct_kernel", (const void*)&rows_direct_kernel},
    {"rows_fused_kernel", (const void*)&rows_fused_kernel},
};

extern "C" int repro_attrs_pencil(int i, const char** name, i64* regs,
                                  i64* local) {
  return kernel_attributes(ATTRS, 6, i, name, regs, local);
}
