// Direct DFT leaf: Y = X . W (.* e per bin), X: (B, N), W: (N, N), N <= 1024.
//
// Replaces the TPU kernel dft_matmul_call (src/repro/kernels/dft_matmul.py:67,
// pallas_call at :100), whose whole DFT matrix sat in VMEM.  Here W is 8 MB
// at N = 1024 — far beyond a block's 227 KB — so the leaf is a tiled complex
// SGEMM: one 64 x 64 output tile per block, W streamed through shared memory
// in 16-deep K-stripes and served from L2 (it is read by every row tile).
//
// Bound on the H100: arithmetic.  The work needs 6.B.N^2 fp32 flops (three
// real GEMMs, the Karatsuba form of the reference) over 16.B.N bytes of
// signal: 3N/8 = 384 flop/B at N = 1024, far above the card's
// 67 TFLOP/s / 3.35 TB/s = 20 flop/B ridge, so the kernel is limited by the
// CUDA cores' FMA rate.  It spends 4 FMAs (8 flops) per complex
// multiply-add, a third more than the work needs, for fewer shared loads
// per FMA and no cancellation.  Its design keeps the FMA pipes fed (4x4
// complex register micro-tiles: 8 shared loads feed 64 FMAs per K step;
// coalesced stripes) and stays off the tensor cores: TF32 keeps ~3 digits
// and would miss the 1e-3 gate at N = 1024 (3xTF32 wgmma is later work).
// Its time against the bound is in PERF.md.
#include "tile.cuh"

using namespace repro;

__global__ void __launch_bounds__(THREADS)
    dft_matmul_kernel(int B, int N, const float* xr, const float* xi,
                      const float* wr, const float* wi, const float* er,
                      const float* ei, float* yr, float* yi) {
  __shared__ float2 smem[2 * BK * LDS];
  const int tn = cdiv(N, BN);
  const int m0 = (int)(blockIdx.x / tn) * BM;
  const int n0 = (int)(blockIdx.x % tn) * BN;
  const CMat X{xr, xi, stride(N), stride(1)};
  const CMat W{wr, wi, stride(N), stride(1)};
  // The epilogue phasor is per bin: the same e[n] for every row.
  const COut Y{yr, yi, stride(N), stride(1), er, ei, stride(0), stride(1)};
  cgemm_tile(B, N, N, m0, n0, X, W, Y, smem);
}

extern "C" int repro_dft_matmul(i64 B, i64 N, const void* xr, const void* xi,
                                const void* wr, const void* wi, const void* er,
                                const void* ei, void* yr, void* yi,
                                void* stream) {
  const i64 blocks = (i64)cdiv(B, BM) * cdiv(N, BN);
  if (B < 1 || N < 1 || B > 0x7fffffff || blocks > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  dft_matmul_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (int)B, (int)N, (const float*)xr, (const float*)xi, (const float*)wr,
      (const float*)wi, (const float*)er, (const float*)ei, (float*)yr,
      (float*)yi);
  return (int)cudaGetLastError();
}

static const KernelEntry ATTRS[] = {
    {"dft_matmul_kernel", (const void*)&dft_matmul_kernel},
};

extern "C" int repro_attrs_dft_matmul(int i, const char** name, i64* regs,
                                      i64* local) {
  return kernel_attributes(ATTRS, 1, i, name, regs, local);
}
