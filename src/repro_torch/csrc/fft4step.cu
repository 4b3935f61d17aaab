// Whole-signal leaf, 2048 <= n <= 65536: y = DFT_n(x) (* scale) in natural
// order (bin k at k) or k1-major order (bin k2*n1 + k1 at k1*n2 + k2),
// .* an optional per-position phasor e, as a radix FFT in shared memory.
//
// Replaces the TPU kernel fft4step_call (src/repro/kernels/fft4step.py:114,
// pallas_call at :162), which ran the four-step A = W1.X, B = A.*T,
// C = B.W2 as two DFT-matrix products on the matrix unit with the whole
// signal in VMEM.  On the H100 the function is bound by bytes: about
// 5 n log2 n flops over 16 n bytes (3-5 flop/B, under the card's 20 flop/B
// ridge), so the kernel does the FFT's work and moves each point as few
// times as it can:
//
// * n <= 16384 (the signal's 8n bytes fit a block's shared memory):
//   fft4step_kernel<T, E, MB> runs the radix engine of radix.cuh over the whole
//   signal (a tile of max(n, 4096) points, one or two signals): one read
//   and one write of each point, butterflies in registers, the exchanges
//   in shared memory, the n roots of unity through the read-only path.
//   k1-major order is only the store's addressing: the last stage leaves
//   the bins in shared memory (padded by one word per n1) and the store
//   walks output positions, so it stays coalesced.  At n = 16384 the block
//   holds the signal in registers (1024 threads of 16 points: half the
//   SM's register file) and 132 KB of exchange buffer, one block per SM,
//   so its load, butterflies and store do not overlap another block's.
//   The buffer keeps both planes (two barriers per exchange, not four):
//   taking re and im in turn through one plane would halve the buffer but
//   not add a block, which the registers bound.
// * n = 32768, 65536: fft4step_slab_kernel keeps the planner's four-step
//   n = n1 x n2.  One block per signal runs phase 1, the n1-point column
//   FFTs with the engine (tiles of 8192 points, 32 columns at n1 = 256:
//   the unit-stride axis), times w_n^(k1 j2), into the signal's slice of a
//   global scratch slab (row-major n1 x n2, as large as the output); then,
//   after a block barrier, phase 2, the n2-point row FFTs from the slab,
//   stored k1-major directly or, for natural order, through shared memory
//   (padded by one word per n2) so the store walks bins k1 with unit
//   stride.  Each point crosses device memory twice each way (32n bytes,
//   half of it partly absorbed by the 50 MB L2).  A thread-block cluster
//   holding the intermediate in distributed shared memory is the
//   alternative left for a later PR.
//
// Every twiddle (the stage twiddles of the n-, n1- and n2-point
// transforms, w_n^(k1 j2)) comes from the one roots table.  The
// inverse's 1/n is applied at the store.  Its times against the byte bound
// are in PERF.md.
#include "radix.cuh"

using namespace repro;

namespace {

// Bin k2 of row k1 = r0 + c to k1-major position k1 n2 + k2.
struct K1Store {
  float* yr;
  float* yi;
  int lg2;
  int r0;
  int cv;
  float scale;
  const float* er;
  const float* ei;
  __device__ __forceinline__ void operator()(int sig, int bin, float2 v) const {
    if (sig >= cv) return;
    const int p = ((r0 + sig) << lg2) + bin;
    v = make_float2(v.x * scale, v.y * scale);
    if (er != nullptr) v = cmulf(v, make_float2(ldro(er + p), ldro(ei + p)));
    yr[p] = v.x;
    yi[p] = v.y;
  }
};

}  // namespace

template <int T, int E, int MB>
__global__ void __launch_bounds__(T, MB)
    fft4step_kernel(i64 B, int lgn, int lg1, int natural, const float* __restrict__ xr,
                    const float* __restrict__ xi, const float* __restrict__ wr,
                    const float* __restrict__ wi, const float* __restrict__ er,
                    const float* __restrict__ ei, float scale, float* yr, float* yi) {
  extern __shared__ float2 smem[];
  constexpr int LGM = T * E == 4096 ? 12 : T * E == 8192 ? 13 : 14;
  float* xre = reinterpret_cast<float*>(smem);
  float* xim = xre + xwords(T * E);
  const int lgc = LGM - lgn;
  const i64 s0 = (i64)blockIdx.x << lgc;
  const i64 left = B - s0;
  const int cv = left < (1LL << lgc) ? (int)left : 1 << lgc;
  const i64 base = s0 << lgn;
  const Geo g{lgn, lgc, false};
  const Roots w = roots_table(wr, wi, lgn);
  const RowLoad ld{xr + base, xi + base, lgn, cv};
  if (natural) {
    radix_fft<T, E>(g, w, xre, xim, ld, RowStore{yr + base, yi + base, lgn, cv, scale, er, ei});
    return;
  }
  radix_fft<T, E>(g, w, xre, xim, ld, NoStore(), lg1);
  // k1-major: position p = k1 n2 + k2 holds bin k2 n1 + k1.
  const int lg2 = lgn - lg1;
  for (int q = threadIdx.x; q < (cv << lgn); q += T) {
    const int sig = q >> lgn;
    const int p = q & ((1 << lgn) - 1);
    const int bin = ((p & ((1 << lg2) - 1)) << lg1) + (p >> lg2);
    const int a = oaddr(g, lg1, sig, bin);
    put(yr + base, yi + base, q, p, make_float2(xre[a], xim[a]), scale, er, ei);
  }
}

__global__ void __launch_bounds__(SL_T, 1)
    fft4step_slab_kernel(int lgn, int lg1, int natural, const float* __restrict__ xr,
                         const float* __restrict__ xi, const float* __restrict__ wr,
                         const float* __restrict__ wi, const float* __restrict__ er,
                         const float* __restrict__ ei, float scale, float* yr, float* yi,
                         float* mr, float* mi) {
  extern __shared__ float2 smem[];
  float* xre = reinterpret_cast<float*>(smem);
  float* xim = xre + xwords(1 << SL_LGM);
  const int lg2 = lgn - lg1;
  const int n1 = 1 << lg1, n2 = 1 << lg2;
  const i64 base = (i64)blockIdx.x << lgn;  // one signal per block
  const Roots w = roots_table(wr, wi, lgn);

  // Phase 1: the n1-point FFT of every column j2, times w_n^(k1 j2).
  const int lgc1 = SL_LGM - lg1;
  const Geo g1{lg1, lgc1, true};
  for (int c0 = 0; c0 < n2; c0 += 1 << lgc1) {
    const int cv = n2 - c0 < (1 << lgc1) ? n2 - c0 : 1 << lgc1;
    radix_fft<SL_T, SL_E>(g1, w, xre, xim, ColLoad{xr + base, xi + base, lg2, c0, cv},
                          ColStore{mr + base, mi + base, lg2, c0, cv, w});
  }
  __syncthreads();  // the slab is complete and visible to the block

  // Phase 2: the n2-point FFT of every row k1 of the slab.
  const int lgc2 = SL_LGM - lg2;
  const Geo g2{lg2, lgc2, false};
  for (int r0 = 0; r0 < n1; r0 += 1 << lgc2) {
    const int cv = n1 - r0 < (1 << lgc2) ? n1 - r0 : 1 << lgc2;
    const RowLoad ld{mr + base + (r0 << lg2), mi + base + (r0 << lg2), lg2, cv};
    if (!natural) {
      radix_fft<SL_T, SL_E>(g2, w, xre, xim, ld,
                            K1Store{yr + base, yi + base, lg2, r0, cv, scale, er, ei});
      continue;
    }
    radix_fft<SL_T, SL_E>(g2, w, xre, xim, ld, NoStore(), lg2);
    // Natural order: bin k2 n1 + k1, consecutive threads on consecutive k1.
    const int lgcv = lgc2 < lg1 ? lgc2 : lg1;  // cv = min(2^lgc2, n1)
    for (int q = threadIdx.x; q < (cv << lg2); q += SL_T) {
      const int sig = q & (cv - 1);
      const int k2 = q >> lgcv;
      const int a = oaddr(g2, lg2, sig, k2);
      const int p = (k2 << lg1) + r0 + sig;
      put(yr + base, yi + base, p, p, make_float2(xre[a], xim[a]), scale, er, ei);
    }
  }
}

// Shared memory fft4step_kernel needs for a whole length-n signal (a tile
// of max(n, 4096) points); past the block's budget the wrapper passes a
// scratch slab and the launch takes the slab kernel.
extern "C" i64 repro_fft4step_smem_bytes(i64 n) {
  return radix_smem_bytes(n < 4096 ? 4096 : n);
}

template <int T, int E, int MB>
static int launch_tile(i64 B, int lgn, int lg1, i64 natural, float scale, const void* xr,
                       const void* xi, const void* wr, const void* wi, const void* er,
                       const void* ei, void* yr, void* yi, cudaStream_t stream) {
  const int lgc = (T * E == 4096 ? 12 : T * E == 8192 ? 13 : 14) - lgn;
  const i64 blocks = (B + (1LL << lgc) - 1) >> lgc;
  if (lgc < 0 || blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const i64 smem = radix_smem_bytes(T * E);
  cudaError_t err = cudaFuncSetAttribute(fft4step_kernel<T, E, MB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fft4step_kernel<T, E, MB><<<(unsigned)blocks, T, (size_t)smem, stream>>>(
      B, lgn, lg1, (int)natural, (const float*)xr, (const float*)xi, (const float*)wr,
      (const float*)wi, (const float*)er, (const float*)ei, scale, (float*)yr, (float*)yi);
  return (int)cudaGetLastError();
}

// wr/wi: the n n-th roots of the direction; inverse != 0 scales by 1/n;
// er/ei: the per-position phasor or null; mr/mi: the (B, n) scratch slab,
// or null for the whole signal in shared memory (n <= 16384).
extern "C" int repro_fft4step(i64 B, i64 n, i64 n1, i64 natural, i64 inverse, const void* xr,
                              const void* xi, const void* wr, const void* wi, const void* er,
                              const void* ei, void* yr, void* yi, void* mr, void* mi,
                              void* stream) {
  const int lgn = log2_exact(n), lg1 = log2_exact(n1);
  // Both factors of at least 32 points: the pad of the k1-major and the
  // slab's natural stores is one word per factor.
  if (B < 1 || lgn < 0 || lg1 < 5 || lgn - lg1 < 5) return (int)cudaErrorInvalidValue;
  const float scale = inverse != 0 ? 1.f / (float)n : 1.f;
  const cudaStream_t st = (cudaStream_t)stream;
  if (mr != nullptr) {
    if (lg1 > SL_LGM || lgn - lg1 > SL_LGM || B > 0x7fffffff) return (int)cudaErrorInvalidValue;
    const i64 smem = radix_smem_bytes(1 << SL_LGM);
    cudaError_t err = cudaFuncSetAttribute(
        fft4step_slab_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    fft4step_slab_kernel<<<(unsigned)B, SL_T, (size_t)smem, st>>>(
        lgn, lg1, (int)natural, (const float*)xr, (const float*)xi, (const float*)wr,
        (const float*)wi, (const float*)er, (const float*)ei, scale, (float*)yr, (float*)yi,
        (float*)mr, (float*)mi);
    return (int)cudaGetLastError();
  }
  if (lgn <= 12)
    return launch_tile<T12, 4096 / T12, MB12>(B, lgn, lg1, natural, scale, xr, xi, wr, wi, er,
                                              ei, yr, yi, st);
  if (lgn == 13)
    return launch_tile<T13, 8192 / T13, MB13>(B, lgn, lg1, natural, scale, xr, xi, wr, wi, er,
                                              ei, yr, yi, st);
  if (lgn == 14)
    return launch_tile<T14, 16384 / T14, MB14>(B, lgn, lg1, natural, scale, xr, xi, wr, wi, er,
                                               ei, yr, yi, st);
  return (int)cudaErrorInvalidValue;
}

static const KernelEntry ATTRS[] = {
    {"fft4step_kernel<256, 16>", (const void*)&fft4step_kernel<T12, 4096 / T12, MB12>},
    {"fft4step_kernel<512, 16>", (const void*)&fft4step_kernel<T13, 8192 / T13, MB13>},
    {"fft4step_kernel<1024, 16>", (const void*)&fft4step_kernel<T14, 16384 / T14, MB14>},
    {"fft4step_slab_kernel", (const void*)&fft4step_slab_kernel},
};

extern "C" int repro_attrs_fft4step(int i, const char** name, i64* regs,
                                    i64* local) {
  return kernel_attributes(ATTRS, 4, i, name, regs, local);
}
