// Bluestein chirp-convolution stages: an FFT of any length n through one
// power-of-two circular convolution of length M >= 2n - 1.
//
// bluestein_fwd  replaces bluestein_fwd_call (src/repro/kernels/bluestein.py:85,
//                pallas_call at :127): x (B, n) -> FFT_M(chirp.x || 0) .* Bhat
//                (B, M), one pass.
// bluestein_inv  replaces bluestein_inv_call (src/repro/kernels/bluestein.py:142,
//                pallas_call at :182): x (B, M) -> post.IFFT_M(x)[:, :n]
//                (B, n), one pass; 1/M at the store and, for an outer
//                inverse, 1/n in `post`.
// bluestein_elem replaces bluestein_elem_call (src/repro/kernels/bluestein.py:197,
//                pallas_call at :240): one elementwise stage of the split
//                regime (M > 65536), whose conv is M's own two-pass program:
//                pre  (B, n) -> chirp.x zero-padded to (B, M),
//                mul  (B, M) -> x .* Bhat,
//                post (B, M) -> post.x[:, :n] (B, n).
//
// On the TPU a batch tile of signals sat in VMEM, was padded there with a
// concatenate and run through the same in-VMEM transform as the other
// leaves.  On the H100 a fused stage is bound by bytes: the M-point FFT is
// about 5 M log2 M flops over 8 (n + M) bytes per signal, under the card's
// 20 flop/B ridge.  So each stage is the radix FFT of radix.cuh, as
// fft4step's, with Bluestein's steps in the policies through which the
// engine reads and writes device memory; the pad never exists in memory:
//
// * forward: the load reads sample pos < n of a row (stride n, the tile's
//   first row in the 64-bit base, 32-bit offsets within it) times
//   chirp[pos], and returns 0 for the pad pos >= n without touching memory
//   (M >= 2n: every input r >= R/2 of the first stage); the store
//   multiplies bin k by Bhat[k].
// * inverse: the plain load of the (B, M) rows; the store keeps bins
//   k < n only, times 1/M and post[k], at row stride n (consecutive
//   threads on consecutive bins).
//
// M <= 16384: one whole-signal tile per block (fft4step.cu's tiles: 4096
// points holding 4096 / M signals, or one signal of 8192 or 16384), each
// point crossing device memory once each way, no scratch.  M = 32768 and
// 65536: the planner's four-step M = n1 x n2 through a global scratch
// slab, as fft4step_slab_kernel: phase 1 the n1-point columns (sample
// j = j1 n2 + j2 under the forward's chirp and mask) times w_M^(k1 j2)
// into the slab, phase 2 the n2-point rows stored through shared memory in
// natural order (times Bhat, or only bins < n times 1/M and post).
//
// The inner transform reads one table of M-th roots: the forward table for
// bluestein_fwd and the inverse one for bluestein_inv, whatever the outer
// direction (the outer direction lives in the chirp tables).
//
// bluestein_elem is bound by bytes (one read and one write of each plane,
// 6 flops per element): one thread per output element with rows mapped to
// blocks as recomb.cu does; `pre` writes the pad's zeros itself, so
// nothing memsets the output.
#include "radix.cuh"

using namespace repro;

namespace {

// Sample pos of the tile's c-th row of x (row stride n) times chirp[pos];
// the pad (pos >= n) and rows past cv read nothing.
struct ChirpRowLoad {
  const float* xr;
  const float* xi;
  const float* cr;
  const float* ci;
  int n;
  int cv;
  __device__ __forceinline__ void operator()(int sig, int pos, float2& v) const {
    if (sig >= cv || pos >= n) {
      v = make_float2(0.f, 0.f);
      return;
    }
    const int off = sig * n + pos;
    v = cmulf(make_float2(xr[off], xi[off]), make_float2(ldro(cr + pos), ldro(ci + pos)));
  }
};

// Column j2 = c0 + c of one signal's (n1, n2) view: sample j = j1 n2 + j2
// times chirp[j]; the pad (j >= n: every row j1 >= ceil(n / n2)) reads
// nothing.
struct ChirpColLoad {
  const float* xr;
  const float* xi;
  const float* cr;
  const float* ci;
  int n;
  int lg2;
  int c0;
  int cv;
  __device__ __forceinline__ void operator()(int sig, int pos, float2& v) const {
    const int j = (pos << lg2) + c0 + sig;
    if (sig >= cv || j >= n) {
      v = make_float2(0.f, 0.f);
      return;
    }
    v = cmulf(make_float2(xr[j], xi[j]), make_float2(ldro(cr + j), ldro(ci + j)));
  }
};

// Bin k < n of the tile's c-th row times the scale and post[k], to row c
// of y (stride n); bins k >= n are dropped.
struct PostStore {
  float* yr;
  float* yi;
  const float* pr;
  const float* pi;
  int n;
  int cv;
  float scale;
  __device__ __forceinline__ void operator()(int sig, int bin, float2 v) const {
    if (sig >= cv || bin >= n) return;
    v = cmulf(make_float2(v.x * scale, v.y * scale), make_float2(ldro(pr + bin), ldro(pi + bin)));
    const int off = sig * n + bin;
    yr[off] = v.x;
    yi[off] = v.y;
  }
};

// The four-step M = 2^lgm = n1 x n2 of one signal through its slice of the
// scratch slab (mr / mi): phase 1, the n1-point FFT of every column j2,
// read through ld (its c0 and cv set per chunk of columns), times
// w_M^(k1 j2) into the slab; after a block barrier, phase 2, the n2-point
// FFT of every row k1 from the slab, bin k = k2 n1 + k1 handed to
// st(0, k, v) with consecutive threads on consecutive k1.
template <class LD, class ST>
__device__ __forceinline__ void slab_fft(int lgm, int lg1, LD ld, float* mr, float* mi,
                                         const Roots& w, float* xre, float* xim, const ST& st) {
  const int lg2 = lgm - lg1;
  const int n1 = 1 << lg1, n2 = 1 << lg2;
  const int lgc1 = SL_LGM - lg1;
  for (int c0 = 0; c0 < n2; c0 += 1 << lgc1) {
    ld.c0 = c0;
    ld.cv = n2 - c0 < (1 << lgc1) ? n2 - c0 : 1 << lgc1;
    radix_fft<SL_T, SL_E>(Geo{lg1, lgc1, true}, w, xre, xim, ld,
                          ColStore{mr, mi, lg2, c0, ld.cv, w});
  }
  __syncthreads();  // the slab is complete and visible to the block

  const int lgc2 = SL_LGM - lg2;
  const Geo g2{lg2, lgc2, false};
  const int lgcv = lgc2 < lg1 ? lgc2 : lg1;  // cv = min(2^lgc2, n1)
  for (int r0 = 0; r0 < n1; r0 += 1 << lgc2) {
    const int cv = 1 << lgcv;
    radix_fft<SL_T, SL_E>(g2, w, xre, xim, RowLoad{mr + (r0 << lg2), mi + (r0 << lg2), lg2, cv},
                          NoStore(), lg2);
    for (int q = threadIdx.x; q < (cv << lg2); q += SL_T) {
      const int sig = q & (cv - 1);
      const int a = oaddr(g2, lg2, sig, q >> lgcv);
      st(0, ((q >> lgcv) << lg1) + r0 + sig, make_float2(xre[a], xim[a]));
    }
  }
}

}  // namespace

// Whole-signal tiles (M <= 16384): a block takes C = 2^t / M adjacent
// signals, t = log2(T E).
template <int T, int E, int MB>
__global__ void __launch_bounds__(T, MB)
    bluestein_fwd_kernel(i64 B, int n, int lgm, const float* __restrict__ xr,
                         const float* __restrict__ xi, const float* __restrict__ cr,
                         const float* __restrict__ ci, const float* __restrict__ wr,
                         const float* __restrict__ wi, const float* __restrict__ br,
                         const float* __restrict__ bi, float* yr, float* yi) {
  extern __shared__ float2 smem[];
  constexpr int LGT = T * E == 4096 ? 12 : T * E == 8192 ? 13 : 14;
  float* xre = reinterpret_cast<float*>(smem);
  float* xim = xre + xwords(T * E);
  const int lgc = LGT - lgm;
  const i64 s0 = (i64)blockIdx.x << lgc;  // the tile's first signal
  const i64 left = B - s0;
  const int cv = left < (1LL << lgc) ? (int)left : 1 << lgc;
  const i64 in = s0 * n, out = s0 << lgm;
  radix_fft<T, E>(Geo{lgm, lgc, false}, roots_table(wr, wi, lgm), xre, xim,
                  ChirpRowLoad{xr + in, xi + in, cr, ci, n, cv},
                  RowStore{yr + out, yi + out, lgm, cv, 1.f, br, bi});
}

template <int T, int E, int MB>
__global__ void __launch_bounds__(T, MB)
    bluestein_inv_kernel(i64 B, int n, int lgm, const float* __restrict__ xr,
                         const float* __restrict__ xi, const float* __restrict__ wr,
                         const float* __restrict__ wi, const float* __restrict__ pr,
                         const float* __restrict__ pi, float scale, float* yr, float* yi) {
  extern __shared__ float2 smem[];
  constexpr int LGT = T * E == 4096 ? 12 : T * E == 8192 ? 13 : 14;
  float* xre = reinterpret_cast<float*>(smem);
  float* xim = xre + xwords(T * E);
  const int lgc = LGT - lgm;
  const i64 s0 = (i64)blockIdx.x << lgc;
  const i64 left = B - s0;
  const int cv = left < (1LL << lgc) ? (int)left : 1 << lgc;
  const i64 in = s0 << lgm, out = s0 * n;
  radix_fft<T, E>(Geo{lgm, lgc, false}, roots_table(wr, wi, lgm), xre, xim,
                  RowLoad{xr + in, xi + in, lgm, cv},
                  PostStore{yr + out, yi + out, pr, pi, n, cv, scale});
}

// The slab forms (M = 32768, 65536): one signal per block.
__global__ void __launch_bounds__(SL_T, 1)
    bluestein_fwd_slab_kernel(int n, int lgm, int lg1, const float* __restrict__ xr,
                              const float* __restrict__ xi, const float* __restrict__ cr,
                              const float* __restrict__ ci, const float* __restrict__ wr,
                              const float* __restrict__ wi, const float* __restrict__ br,
                              const float* __restrict__ bi, float* yr, float* yi, float* mr,
                              float* mi) {
  extern __shared__ float2 smem[];
  float* xre = reinterpret_cast<float*>(smem);
  float* xim = xre + xwords(1 << SL_LGM);
  const i64 in = (i64)blockIdx.x * n, out = (i64)blockIdx.x << lgm;
  slab_fft(lgm, lg1, ChirpColLoad{xr + in, xi + in, cr, ci, n, lgm - lg1, 0, 0}, mr + out,
           mi + out, roots_table(wr, wi, lgm), xre, xim,
           RowStore{yr + out, yi + out, lgm, 1, 1.f, br, bi});
}

__global__ void __launch_bounds__(SL_T, 1)
    bluestein_inv_slab_kernel(int n, int lgm, int lg1, const float* __restrict__ xr,
                              const float* __restrict__ xi, const float* __restrict__ wr,
                              const float* __restrict__ wi, const float* __restrict__ pr,
                              const float* __restrict__ pi, float scale, float* yr, float* yi,
                              float* mr, float* mi) {
  extern __shared__ float2 smem[];
  float* xre = reinterpret_cast<float*>(smem);
  float* xim = xre + xwords(1 << SL_LGM);
  const i64 in = (i64)blockIdx.x << lgm, out = (i64)blockIdx.x * n;
  slab_fft(lgm, lg1, ColLoad{xr + in, xi + in, lgm - lg1, 0, 0}, mr + in, mi + in,
           roots_table(wr, wi, lgm), xre, xim,
           PostStore{yr + out, yi + out, pr, pi, n, 1, scale});
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


// Launch one of this file's radix kernels over `blocks` blocks with `smem`
// bytes of dynamic shared memory.
template <class... P, class... A>
static int launch(void (*kernel)(P...), i64 blocks, int threads, i64 smem, cudaStream_t st,
                  A... args) {
  if (blocks < 1 || blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, threads, (size_t)smem, st>>>(args...);
  return (int)cudaGetLastError();
}

// Blocks of a whole-signal tile of 2^lgt points over B signals of 2^lgm.
static i64 tiles(i64 B, int lgm, int lgt) {
  const int lgc = lgt - lgm;
  return (B + (1LL << lgc) - 1) >> lgc;
}

// The checks both fused stages share: a power-of-two pad M >= 2n - 1 up to
// 65536, and for the slab form (mr != null, M >= 2048) factors of 32 to
// 8192 points (one pad word per factor in the natural-order store);
// returns log2 M, or -1.
static int fused_ok(i64 B, i64 n, i64 M, i64 n1, const void* mr, int* lg1) {
  const int lgm = log2_exact(M);
  *lg1 = log2_exact(n1);
  if (B < 1 || n < 2 || lgm < 0 || lgm > 16 || M < 2 * n - 1) return -1;
  if (mr == nullptr) return lgm > 14 ? -1 : lgm;
  if (*lg1 < 5 || *lg1 > SL_LGM || lgm - *lg1 < 5 || lgm - *lg1 > SL_LGM) return -1;
  return lgm;
}

// cr/ci: the (n,) chirp; wr/wi: the (M,) forward roots; br/bi: the (M,)
// chirp spectrum; mr/mi: the (B, M) scratch slab of the four-step of first
// factor n1, or null for one whole-signal tile per block (M <= 16384).
extern "C" int repro_bluestein_fwd(i64 B, i64 n, i64 M, i64 n1, const void* xr, const void* xi,
                                   const void* cr, const void* ci, const void* wr,
                                   const void* wi, const void* br, const void* bi, void* yr,
                                   void* yi, void* mr, void* mi, void* stream) {
  int lg1;
  const int lgm = fused_ok(B, n, M, n1, mr, &lg1);
  if (lgm < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const float *x_r = (const float*)xr, *x_i = (const float*)xi, *c_r = (const float*)cr,
              *c_i = (const float*)ci, *w_r = (const float*)wr, *w_i = (const float*)wi,
              *b_r = (const float*)br, *b_i = (const float*)bi;
  float *y_r = (float*)yr, *y_i = (float*)yi;
  if (mr != nullptr)
    return launch(bluestein_fwd_slab_kernel, B, SL_T, radix_smem_bytes(1 << SL_LGM), st, (int)n,
                  lgm, lg1, x_r, x_i, c_r, c_i, w_r, w_i, b_r, b_i, y_r, y_i, (float*)mr,
                  (float*)mi);
  if (lgm <= 12)
    return launch(bluestein_fwd_kernel<T12, 4096 / T12, MB12>, tiles(B, lgm, 12), T12,
                  radix_smem_bytes(4096), st, B, (int)n, lgm, x_r, x_i, c_r, c_i, w_r, w_i, b_r,
                  b_i, y_r, y_i);
  if (lgm == 13)
    return launch(bluestein_fwd_kernel<T13, 8192 / T13, MB13>, tiles(B, lgm, 13), T13,
                  radix_smem_bytes(8192), st, B, (int)n, lgm, x_r, x_i, c_r, c_i, w_r, w_i, b_r,
                  b_i, y_r, y_i);
  return launch(bluestein_fwd_kernel<T14, 16384 / T14, MB14>, tiles(B, lgm, 14), T14,
                radix_smem_bytes(16384), st, B, (int)n, lgm, x_r, x_i, c_r, c_i, w_r, w_i, b_r,
                b_i, y_r, y_i);
}

// wr/wi: the (M,) inverse roots; pr/pi: the (n,) post-chirp; 1/M applied
// at the store; mr/mi as repro_bluestein_fwd's.
extern "C" int repro_bluestein_inv(i64 B, i64 n, i64 M, i64 n1, const void* xr, const void* xi,
                                   const void* wr, const void* wi, const void* pr,
                                   const void* pi, void* yr, void* yi, void* mr, void* mi,
                                   void* stream) {
  int lg1;
  const int lgm = fused_ok(B, n, M, n1, mr, &lg1);
  if (lgm < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const float scale = 1.f / (float)M;
  const float *x_r = (const float*)xr, *x_i = (const float*)xi, *w_r = (const float*)wr,
              *w_i = (const float*)wi, *p_r = (const float*)pr, *p_i = (const float*)pi;
  float *y_r = (float*)yr, *y_i = (float*)yi;
  if (mr != nullptr)
    return launch(bluestein_inv_slab_kernel, B, SL_T, radix_smem_bytes(1 << SL_LGM), st, (int)n,
                  lgm, lg1, x_r, x_i, w_r, w_i, p_r, p_i, scale, y_r, y_i, (float*)mr,
                  (float*)mi);
  if (lgm <= 12)
    return launch(bluestein_inv_kernel<T12, 4096 / T12, MB12>, tiles(B, lgm, 12), T12,
                  radix_smem_bytes(4096), st, B, (int)n, lgm, x_r, x_i, w_r, w_i, p_r, p_i,
                  scale, y_r, y_i);
  if (lgm == 13)
    return launch(bluestein_inv_kernel<T13, 8192 / T13, MB13>, tiles(B, lgm, 13), T13,
                  radix_smem_bytes(8192), st, B, (int)n, lgm, x_r, x_i, w_r, w_i, p_r, p_i,
                  scale, y_r, y_i);
  return launch(bluestein_inv_kernel<T14, 16384 / T14, MB14>, tiles(B, lgm, 14), T14,
                radix_smem_bytes(16384), st, B, (int)n, lgm, x_r, x_i, w_r, w_i, p_r, p_i, scale,
                y_r, y_i);
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
    {"bluestein_fwd_kernel<256, 16>", (const void*)&bluestein_fwd_kernel<T12, 4096 / T12, MB12>},
    {"bluestein_fwd_kernel<512, 16>", (const void*)&bluestein_fwd_kernel<T13, 8192 / T13, MB13>},
    {"bluestein_fwd_kernel<1024, 16>", (const void*)&bluestein_fwd_kernel<T14, 16384 / T14, MB14>},
    {"bluestein_fwd_slab_kernel", (const void*)&bluestein_fwd_slab_kernel},
    {"bluestein_inv_kernel<256, 16>", (const void*)&bluestein_inv_kernel<T12, 4096 / T12, MB12>},
    {"bluestein_inv_kernel<512, 16>", (const void*)&bluestein_inv_kernel<T13, 8192 / T13, MB13>},
    {"bluestein_inv_kernel<1024, 16>", (const void*)&bluestein_inv_kernel<T14, 16384 / T14, MB14>},
    {"bluestein_inv_slab_kernel", (const void*)&bluestein_inv_slab_kernel},
    {"bluestein_elem_kernel", (const void*)&bluestein_elem_kernel},
};

extern "C" int repro_attrs_bluestein(int i, const char** name, i64* regs,
                                     i64* local) {
  return kernel_attributes(ATTRS, 9, i, name, regs, local);
}
