// Bluestein chirp-convolution stages: an FFT of any length n through one
// power-of-two circular convolution of length M >= 2n - 1.
//
// bluestein_fwd  replaces bluestein_fwd_call (src/repro/kernels/bluestein.py:85,
//                pallas_call at :127): x (B, n) -> FFT_M(chirp.x || 0) .* Bhat
//                (B, M), one pass.
// bluestein_inv  replaces bluestein_inv_call (src/repro/kernels/bluestein.py:142,
//                pallas_call at :182): x (B, M) -> post.IFFT_M(x)[:, :n]
//                (B, n), one pass; 1/M sits in the inner LUTs and, for an
//                outer inverse, 1/n in `post`.
// bluestein_elem replaces bluestein_elem_call (src/repro/kernels/bluestein.py:197,
//                pallas_call at :240): one elementwise stage of the split
//                regime (M > 65536), whose conv is M's own two-pass program:
//                pre  (B, n) -> chirp.x zero-padded to (B, M),
//                mul  (B, M) -> x .* Bhat,
//                post (B, M) -> post.x[:, :n] (B, n).
//
// On the TPU a batch tile of signals sat in VMEM, was padded there with a
// concatenate and run through the same in-VMEM transform as the other
// leaves.  Here the fused stages are the leaves' own GEMM tiles (tile.cuh)
// with the chirp and the pad folded into their loads and stores, so the pad
// never exists in memory and its rows cost no arithmetic:
//
// * Direct inner (M <= 1024).  Only the first n rows of the M x M DFT
//   matrix meet data, so the forward stage is one rectangular GEMM
//   x (B, n) . W[:n, :] (B, M): the pre-chirp multiplies x as it is loaded
//   (ChirpLoad on the K index) and Bhat is the per-bin epilogue phasor.  The
//   inverse is x (B, M) . W_inv[:, :n], post-chirp as the epilogue: only
//   the n bins kept are computed.
// * Four-step inner (2048 <= M <= 65536).  The chirp depends on
//   j = j1 n2 + j2 jointly, so GEMM 1 loads chirp.x with the pad masked
//   (ChirpLoad on the (j1, q) view: j >= n reads 0) and stops at the
//   ceil(n / n2) rows j1 that carry data.  The inverse's GEMM 2 stores only
//   bins k = k2 n1 + k1 < n (BinMask) and stops at k2 < ceil(n / n1).  The
//   intermediate follows fft4step's rule: shared memory while M.C <= 16384,
//   the wrapper's global scratch slab beyond.
//
// Bound on the H100.  The fused stages: arithmetic, as the leaves (6 flops
// per complex multiply-add of the rows that carry data over 8 (n + M) bytes
// per signal; the tiles spend 8).  bluestein_elem: bytes (one read and one
// write of each plane, 6 flops per element), one thread per output element
// with rows mapped to blocks as recomb.cu does; `pre` writes the pad's
// zeros itself, so nothing memsets the output.
#include "tile.cuh"

using namespace repro;

__global__ void __launch_bounds__(THREADS)
    bluestein_fwd_direct_kernel(int B, int n, int M, const float* xr,
                                const float* xi, const float* cr,
                                const float* ci, const float* wr,
                                const float* wi, const float* br,
                                const float* bi, float* yr, float* yi) {
  __shared__ float2 smem[2 * BK * LDS];
  const int tn = cdiv(M, BN);
  const int m0 = (int)(blockIdx.x / tn) * BM;
  const int n0 = (int)(blockIdx.x % tn) * BN;
  const CMat X{xr, xi, stride(n), stride(1)};
  const CMat W{wr, wi, stride(M), stride(1)};  // its first n rows
  const COut Y{yr, yi, stride(M), stride(1), br, bi, stride(0), stride(1)};
  // Column k of X is sample j = k: x[b, k] * chirp[k].
  const ChirpLoad chirp{cr, ci, n, 0, -1};
  cgemm_tile(B, M, n, m0, n0, X, W, Y, smem, chirp);
}

__global__ void __launch_bounds__(THREADS)
    bluestein_inv_direct_kernel(int B, int n, int M, const float* xr,
                                const float* xi, const float* wr,
                                const float* wi, const float* pr,
                                const float* pi, float* yr, float* yi) {
  __shared__ float2 smem[2 * BK * LDS];
  const int tn = cdiv(n, BN);
  const int m0 = (int)(blockIdx.x / tn) * BM;
  const int n0 = (int)(blockIdx.x % tn) * BN;
  const CMat X{xr, xi, stride(M), stride(1)};
  const CMat W{wr, wi, stride(M), stride(1)};  // its first n columns
  const COut Y{yr, yi, stride(n), stride(1), pr, pi, stride(0), stride(1)};
  cgemm_tile(B, n, M, m0, n0, X, W, Y, smem);
}

// The intermediate of a chunk: the block's slice of the scratch slab, or
// shared memory past the GEMM staging.
__device__ __forceinline__ void mid_planes(float* scr_re, float* scr_im,
                                           i64 base, i64 size, float2* smem,
                                           float** mid_re, float** mid_im) {
  if (scr_re != nullptr) {
    *mid_re = scr_re + base;
    *mid_im = scr_im + base;
  } else {
    *mid_re = reinterpret_cast<float*>(smem + 2 * BK * LDS);
    *mid_im = *mid_re + size;
  }
}

__global__ void __launch_bounds__(THREADS)
    bluestein_fwd_fused_kernel(int n, int n1, int lg1, int n2, int lg2, int lgc,
                               const float* xr, const float* xi,
                               const float* cr, const float* ci,
                               const float* w1r, const float* w1i,
                               const float* tr, const float* ti,
                               const float* w2r, const float* w2i,
                               const float* br, const float* bi, float* yr,
                               float* yi, float* scr_re, float* scr_im) {
  extern __shared__ float2 smem[];
  const i64 M = (i64)n1 * n2;
  const i64 in_base = (i64)blockIdx.x * ((i64)n << lgc);
  const i64 out_base = (i64)blockIdx.x * (M << lgc);
  const Sig x{xr + in_base, xi + in_base, n, 1};
  const SigOut y{yr + out_base, yi + out_base, M, 1, br, bi, 0, 1};
  float* mid_re;
  float* mid_im;
  mid_planes(scr_re, scr_im, out_base, M << lgc, smem, &mid_re, &mid_im);
  // GEMM 1's B element (j1, q) is sample j = j1 * n2 + (q mod n2).
  const ChirpLoad chirp{cr, ci, n, n2, n2 - 1};
  four_step_tile(n1, lg1, n2, lg2, lgc, w1r, w1i, tr, ti, w2r, w2i, x, y,
                 true, mid_re, mid_im, smem, chirp, PlainStore(),
                 cdiv(n, n2), 0);
}

__global__ void __launch_bounds__(THREADS)
    bluestein_inv_fused_kernel(int n, int n1, int lg1, int n2, int lg2, int lgc,
                               const float* xr, const float* xi,
                               const float* w1r, const float* w1i,
                               const float* tr, const float* ti,
                               const float* w2r, const float* w2i,
                               const float* pr, const float* pi, float* yr,
                               float* yi, float* scr_re, float* scr_im) {
  extern __shared__ float2 smem[];
  const i64 M = (i64)n1 * n2;
  const i64 in_base = (i64)blockIdx.x * (M << lgc);
  const i64 out_base = (i64)blockIdx.x * ((i64)n << lgc);
  const Sig x{xr + in_base, xi + in_base, M, 1};
  const SigOut y{yr + out_base, yi + out_base, n, 1, pr, pi, 0, 1};
  float* mid_re;
  float* mid_im;
  mid_planes(scr_re, scr_im, in_base, M << lgc, smem, &mid_re, &mid_im);
  four_step_tile(n1, lg1, n2, lg2, lgc, w1r, w1i, tr, ti, w2r, w2i, x, y,
                 true, mid_re, mid_im, smem, PlainLoad(), BinMask{n, n1}, 0,
                 cdiv(n, n1));
}

// out[b, k] = x[b, k] * lut[k] for k < w_data, 0 for w_data <= k < w_out.
__global__ void __launch_bounds__(THREADS)
    bluestein_elem_kernel(i64 w_in, i64 w_out, i64 w_data, int per_row,
                          const float* xr, const float* xi, const float* lr,
                          const float* li, float* yr, float* yi) {
  const i64 b = blockIdx.x / per_row;
  const i64 k = (i64)(blockIdx.x % per_row) * THREADS + threadIdx.x;
  if (k >= w_out) return;
  float vr = 0.f, vi = 0.f;
  if (k < w_data) {
    const float ar = xr[b * w_in + k], ai = xi[b * w_in + k];
    const float cr = lr[k], ci = li[k];
    vr = ar * cr - ai * ci;
    vi = ar * ci + ai * cr;
  }
  yr[b * w_out + k] = vr;
  yi[b * w_out + k] = vi;
}

static int log2_exact(i64 v) {
  int lg = 0;
  while ((1LL << lg) < v) ++lg;
  return (1LL << lg) == v ? lg : -1;
}

static bool direct_ok(i64 B, i64 n, i64 M, i64 blocks) {
  return B >= 1 && B <= 0x7fffffff && n >= 2 && M <= 1024 &&
         log2_exact(M) >= 0 && M >= 2 * n - 1 && blocks <= 0x7fffffff;
}

// The fused stages' common launch checks; returns the shared memory a block
// takes (-1: invalid).
static i64 fused_smem(i64 B, i64 n, i64 n1, i64 n2, i64 lgc, const void* scr,
                      int* lg1, int* lg2) {
  *lg1 = log2_exact(n1);
  *lg2 = log2_exact(n2);
  if (*lg1 < 0 || *lg2 < 0 || lgc < 0 || B < 1 || B % (1LL << lgc) != 0 ||
      n < 2 || n1 * n2 < 2 * n - 1 || n1 * n2 > 65536 ||
      (B >> lgc) > 0x7fffffff)
    return -1;
  return scr != nullptr ? TILE_SMEM_BYTES : four_step_smem_bytes(n1 * n2, (int)lgc);
}

extern "C" int repro_bluestein_fwd_direct(i64 B, i64 n, i64 M, const void* xr,
                                          const void* xi, const void* cr,
                                          const void* ci, const void* wr,
                                          const void* wi, const void* br,
                                          const void* bi, void* yr, void* yi,
                                          void* stream) {
  const i64 blocks = (i64)cdiv(B, BM) * cdiv(M, BN);
  if (!direct_ok(B, n, M, blocks)) return (int)cudaErrorInvalidValue;
  bluestein_fwd_direct_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (int)B, (int)n, (int)M, (const float*)xr, (const float*)xi,
      (const float*)cr, (const float*)ci, (const float*)wr, (const float*)wi,
      (const float*)br, (const float*)bi, (float*)yr, (float*)yi);
  return (int)cudaGetLastError();
}

extern "C" int repro_bluestein_inv_direct(i64 B, i64 n, i64 M, const void* xr,
                                          const void* xi, const void* wr,
                                          const void* wi, const void* pr,
                                          const void* pi, void* yr, void* yi,
                                          void* stream) {
  const i64 blocks = (i64)cdiv(B, BM) * cdiv(n, BN);
  if (!direct_ok(B, n, M, blocks)) return (int)cudaErrorInvalidValue;
  bluestein_inv_direct_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (int)B, (int)n, (int)M, (const float*)xr, (const float*)xi,
      (const float*)wr, (const float*)wi, (const float*)pr, (const float*)pi,
      (float*)yr, (float*)yi);
  return (int)cudaGetLastError();
}

extern "C" int repro_bluestein_fwd_fused(
    i64 B, i64 n, i64 n1, i64 n2, i64 lgc, const void* xr, const void* xi,
    const void* cr, const void* ci, const void* w1r, const void* w1i,
    const void* tr, const void* ti, const void* w2r, const void* w2i,
    const void* br, const void* bi, void* yr, void* yi, void* scr_re,
    void* scr_im, void* stream) {
  int lg1, lg2;
  const i64 smem = fused_smem(B, n, n1, n2, lgc, scr_re, &lg1, &lg2);
  if (smem < 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      bluestein_fwd_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)(B >> lgc);
  bluestein_fwd_fused_kernel<<<blocks, THREADS, (size_t)smem, (cudaStream_t)stream>>>(
      (int)n, (int)n1, lg1, (int)n2, lg2, (int)lgc, (const float*)xr,
      (const float*)xi, (const float*)cr, (const float*)ci, (const float*)w1r,
      (const float*)w1i, (const float*)tr, (const float*)ti, (const float*)w2r,
      (const float*)w2i, (const float*)br, (const float*)bi, (float*)yr,
      (float*)yi, (float*)scr_re, (float*)scr_im);
  return (int)cudaGetLastError();
}

extern "C" int repro_bluestein_inv_fused(
    i64 B, i64 n, i64 n1, i64 n2, i64 lgc, const void* xr, const void* xi,
    const void* w1r, const void* w1i, const void* tr, const void* ti,
    const void* w2r, const void* w2i, const void* pr, const void* pi,
    void* yr, void* yi, void* scr_re, void* scr_im, void* stream) {
  int lg1, lg2;
  const i64 smem = fused_smem(B, n, n1, n2, lgc, scr_re, &lg1, &lg2);
  if (smem < 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      bluestein_inv_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)(B >> lgc);
  bluestein_inv_fused_kernel<<<blocks, THREADS, (size_t)smem, (cudaStream_t)stream>>>(
      (int)n, (int)n1, lg1, (int)n2, lg2, (int)lgc, (const float*)xr,
      (const float*)xi, (const float*)w1r, (const float*)w1i,
      (const float*)tr, (const float*)ti, (const float*)w2r, (const float*)w2i,
      (const float*)pr, (const float*)pi, (float*)yr, (float*)yi,
      (float*)scr_re, (float*)scr_im);
  return (int)cudaGetLastError();
}

extern "C" int repro_bluestein_elem(i64 B, i64 w_in, i64 w_out,
                                    const void* xr, const void* xi,
                                    const void* lr, const void* li, void* yr,
                                    void* yi, void* stream) {
  if (B < 1 || w_in < 1 || w_out < 1) return (int)cudaErrorInvalidValue;
  const i64 per_row = (w_out + THREADS - 1) / THREADS;
  const i64 blocks = B * per_row;
  if (per_row > 0x7fffffff || blocks > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const i64 w_data = w_in < w_out ? w_in : w_out;
  bluestein_elem_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      w_in, w_out, w_data, (int)per_row, (const float*)xr, (const float*)xi,
      (const float*)lr, (const float*)li, (float*)yr, (float*)yi);
  return (int)cudaGetLastError();
}

static const KernelEntry ATTRS[] = {
    {"bluestein_fwd_direct_kernel", (const void*)&bluestein_fwd_direct_kernel},
    {"bluestein_fwd_fused_kernel", (const void*)&bluestein_fwd_fused_kernel},
    {"bluestein_inv_direct_kernel", (const void*)&bluestein_inv_direct_kernel},
    {"bluestein_inv_fused_kernel", (const void*)&bluestein_inv_fused_kernel},
    {"bluestein_elem_kernel", (const void*)&bluestein_elem_kernel},
};

extern "C" int repro_attrs_bluestein(int i, const char** name, i64* regs,
                                     i64* local) {
  return kernel_attributes(ATTRS, 5, i, name, regs, local);
}
