// Fused four-step leaf: one HBM round trip for 2048 <= n <= 65536.
//
// Replaces the TPU kernel fft4step_call (src/repro/kernels/fft4step.py:114,
// pallas_call at :162): A = W1.X, B = A.*T, C = B.W2 per signal, written in
// natural order (bin k2*n1 + k1) or k1-major, times an optional per-position
// phasor e.  Each block transforms a chunk of C = 2^lgc signals with
// four_step_tile (tile.cuh); the LUTs W1, T, W2 are read through L2.
//
// Bound on the H100: arithmetic.  The work needs 6.n.(n1 + n2) + 14n fp32
// flops per signal (three real GEMMs per complex product, their pre- and
// post-adds, the twiddle) over 16n bytes: 3(n1 + n2)/8 ~ 24..192 flop/B,
// above the 20 flop/B ridge.  The tiles spend 8 flops (4 FMAs) per complex
// multiply-add.
//
// Where the intermediate B lives.  On the TPU all of a signal sat in VMEM.
// A block here has 227 KB: the n1 x n2 intermediate of C signals fits up to
// n.C = 16384 (128 KB + the 16.6 KB GEMM staging), and then lives in shared
// memory.  Above that (n = 32768 and 65536) the wrapper passes a global
// scratch slab as large as the output, each block owning its chunk's slice:
// GEMM 1 writes it, GEMM 2 reads it back after a block barrier.  That costs
// up to 16n extra bytes per signal (a write and a read, partly absorbed by
// the 50 MB L2), which the arithmetic bound hides, and 8n bytes of device
// memory per signal while the call runs: half again the 16n of its planes
// in and out, so a third off the largest batch the card takes.  A cluster spreading the
// intermediate over distributed shared memory is the alternative left for
// the PR that makes this kernel fast.
#include "tile.cuh"

using namespace repro;

__global__ void __launch_bounds__(THREADS)
    fft4step_kernel(int n1, int lg1, int n2, int lg2, int lgc, int natural,
                    const float* xr, const float* xi, const float* w1r,
                    const float* w1i, const float* tr, const float* ti,
                    const float* w2r, const float* w2i, const float* er,
                    const float* ei, float* yr, float* yi, float* scr_re,
                    float* scr_im) {
  extern __shared__ float2 smem[];
  const i64 n = (i64)n1 * n2;
  const i64 base = (i64)blockIdx.x * (n << lgc);
  const Sig x{xr + base, xi + base, n, 1};
  const SigOut y{yr + base, yi + base, n, 1, er, ei, 0, 1};
  float* mid_re;
  float* mid_im;
  if (scr_re != nullptr) {
    mid_re = scr_re + base;
    mid_im = scr_im + base;
  } else {
    mid_re = reinterpret_cast<float*>(smem + 2 * BK * LDS);
    mid_im = mid_re + (n << lgc);
  }
  four_step_tile(n1, lg1, n2, lg2, lgc, w1r, w1i, tr, ti, w2r, w2i, x, y,
                 natural != 0, mid_re, mid_im, smem);
}

static int log2_exact(i64 v) {
  int lg = 0;
  while ((1LL << lg) < v) ++lg;
  return (1LL << lg) == v ? lg : -1;
}

// Shared memory a four-step block needs with its intermediate on chip.
extern "C" i64 repro_four_step_smem_bytes(i64 n, i64 lgc) {
  return four_step_smem_bytes(n, (int)lgc);
}

extern "C" int repro_fft4step(i64 B, i64 n1, i64 n2, i64 lgc, i64 natural,
                              const void* xr, const void* xi, const void* w1r,
                              const void* w1i, const void* tr, const void* ti,
                              const void* w2r, const void* w2i, const void* er,
                              const void* ei, void* yr, void* yi, void* scr_re,
                              void* scr_im, void* stream) {
  const int lg1 = log2_exact(n1), lg2 = log2_exact(n2);
  if (lg1 < 0 || lg2 < 0 || lgc < 0 || B < 1 || B % (1LL << lgc) != 0)
    return (int)cudaErrorInvalidValue;
  const i64 blocks = B >> lgc;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const i64 smem =
      scr_re != nullptr ? TILE_SMEM_BYTES : four_step_smem_bytes(n1 * n2, (int)lgc);
  cudaError_t err = cudaFuncSetAttribute(
      fft4step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fft4step_kernel<<<(unsigned)blocks, THREADS, (size_t)smem, (cudaStream_t)stream>>>(
      (int)n1, lg1, (int)n2, lg2, (int)lgc, (int)natural, (const float*)xr,
      (const float*)xi, (const float*)w1r, (const float*)w1i, (const float*)tr,
      (const float*)ti, (const float*)w2r, (const float*)w2i, (const float*)er,
      (const float*)ei, (float*)yr, (float*)yi, (float*)scr_re, (float*)scr_im);
  return (int)cudaGetLastError();
}

static const KernelEntry ATTRS[] = {
    {"fft4step_kernel", (const void*)&fft4step_kernel},
};

extern "C" int repro_attrs_fft4step(int i, const char** name, i64* regs,
                                    i64* local) {
  return kernel_attributes(ATTRS, 1, i, name, regs, local);
}
