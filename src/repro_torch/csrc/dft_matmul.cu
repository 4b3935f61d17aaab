// Whole-signal leaf, N <= 1024: y = DFT_N(x) (* scale, .* e per bin) as a
// radix FFT in shared memory.
//
// Replaces the TPU kernel dft_matmul_call (src/repro/kernels/dft_matmul.py:67,
// pallas_call at :100), which multiplied each tile by the whole N x N DFT
// matrix resident in VMEM on the matrix unit.  On the H100 the function is
// bound by bytes: an FFT needs about 5 N log2 N flops over the 16 N bytes
// each signal must read and write (about 3 flop/B at N = 1024), far under
// the card's 67 TFLOP/s / 3.35 TB/s = 20 flop/B ridge.  So the kernel does
// the FFT's work, not the DFT matrix's O(N^2): one block takes a contiguous
// chunk of 4096 / N signals (a tile of 4096 points; one range of each
// plane, so loads and stores coalesce), reads each point from device memory
// once and writes it once, runs radix-2/4/8 butterflies in registers with
// the exchanges between stages in shared memory (radix.cuh), reads the N
// roots of unity (8N bytes, where the DFT matrix held 8N^2) through the
// read-only path, and applies the inverse's 1/N and the per-bin phasor e at
// the store.  Its time against the byte bound is in PERF.md.
#include "radix.cuh"

using namespace repro;

namespace {

constexpr int DM_T = 256;   // threads per block
constexpr int DM_LGM = 12;  // a tile of 4096 points
constexpr int DM_E = (1 << DM_LGM) / DM_T;  // points per thread
// Four blocks per SM: at most 64 registers a thread, none spilled.
constexpr int DM_MINB = 4;

}  // namespace

__global__ void __launch_bounds__(DM_T, DM_MINB)
    dft_matmul_kernel(i64 B, int lgn, const float* __restrict__ xr,
                      const float* __restrict__ xi, const float* __restrict__ wr,
                      const float* __restrict__ wi, const float* __restrict__ er,
                      const float* __restrict__ ei, float scale, float* yr, float* yi) {
  __shared__ float xre[xwords(1 << DM_LGM)];
  __shared__ float xim[xwords(1 << DM_LGM)];
  const int lgc = DM_LGM - lgn;
  const i64 s0 = (i64)blockIdx.x << lgc;  // the tile's first signal
  const i64 left = B - s0;
  const int cv = left < (1LL << lgc) ? (int)left : 1 << lgc;
  const i64 base = s0 << lgn;
  const Geo g{lgn, lgc, false};
  radix_fft<DM_T, DM_E>(g, roots_table(wr, wi, lgn), xre, xim,
                        RowLoad{xr + base, xi + base, lgn, cv},
                        RowStore{yr + base, yi + base, lgn, cv, scale, er, ei});
}

// wr/wi: the N n-th roots of the direction (tables of core/twiddle.py
// roots); inverse != 0 scales by 1/N; er/ei: the per-bin phasor or null.
extern "C" int repro_dft_matmul(i64 B, i64 N, i64 inverse, const void* xr, const void* xi,
                                const void* wr, const void* wi, const void* er,
                                const void* ei, void* yr, void* yi, void* stream) {
  const int lgn = log2_exact(N);
  if (B < 1 || lgn < 0 || lgn > DM_LGM) return (int)cudaErrorInvalidValue;
  const i64 blocks = (B + (1LL << (DM_LGM - lgn)) - 1) >> (DM_LGM - lgn);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const float scale = inverse != 0 ? 1.f / (float)N : 1.f;
  dft_matmul_kernel<<<(unsigned)blocks, DM_T, 0, (cudaStream_t)stream>>>(
      B, lgn, (const float*)xr, (const float*)xi, (const float*)wr, (const float*)wi,
      (const float*)er, (const float*)ei, scale, (float*)yr, (float*)yi);
  return (int)cudaGetLastError();
}

static const KernelEntry ATTRS[] = {
    {"dft_matmul_kernel", (const void*)&dft_matmul_kernel},
};

extern "C" int repro_attrs_dft_matmul(int i, const char** name, i64* regs,
                                      i64* local) {
  return kernel_attributes(ATTRS, 1, i, name, regs, local);
}
