// Hermitian recombination of the real-FFT even/odd packing: one elementwise
// pass each way.
//
// rfft_recomb  replaces rfft_recomb_call (src/repro/kernels/pencil.py:313,
//              via _recomb_call, pallas_call at :298): the packed m-point
//              spectrum Z (B, m) of a length-2m real signal becomes its
//              m + 1 bins X (B, m + 1):
//                E[k] = (Z[k] + conj Z[(m - k) mod m]) / 2,
//                O[k] = -i (Z[k] - conj Z[(m - k) mod m]) / 2,
//                X[k] = E[k] + w[k] O[k] (k < m),   X[m] = E[0] - O[0],
//              with w[k] = e^{-2 pi i k / 2m} (src/repro/core/fft_xla.py:51).
// irfft_recomb replaces irfft_recomb_call (src/repro/kernels/pencil.py:324):
//              the inverse, X (B, m + 1) -> Z (B, m):
//                E = (X[k] + conj X[m - k]) / 2, D = (X[k] - conj X[m - k]) / 2,
//                Z[k] = E + i w[k] D,  w[k] = e^{+2 pi i k / 2m}
//              (src/repro/core/fft_xla.py:73); the inverse's 1/m scaling
//              lives in the inner transform's LUTs, not here.
//
// On the TPU the whole half-spectrum row sat in VMEM and the reversal was an
// in-register flip + roll.  Here one thread makes one output element and
// reads its two inputs from device memory: the mirrored read Z[m - k] walks
// the same sectors backwards, so both reads of a warp stay coalesced.  Rows
// map to blocks (ceil((m + 1) / 256) blocks per row), so no thread divides
// a 64-bit index.
//
// Bound on the H100: bytes.  Each pass reads the planes in once and writes
// the planes out once (8 bytes per complex element each way) plus the
// (m + 1) phasor LUT, for about 8 flops per element: far below the card's
// 20 flop/B ridge.
#include "tile.cuh"

using namespace repro;

__global__ void __launch_bounds__(THREADS)
    rfft_recomb_kernel(i64 m, int per_row, const float* zr, const float* zi,
                       const float* wr, const float* wi, float* xr,
                       float* xi) {
  const i64 b = blockIdx.x / per_row;
  const i64 k = (i64)(blockIdx.x % per_row) * THREADS + threadIdx.x;
  if (k > m) return;
  const float* zr_b = zr + b * m;
  const float* zi_b = zi + b * m;
  // X[m] is made of E[0] and O[0]; Z[(m - k) mod m] is Z[0] at k = 0.
  const i64 kk = k == m ? 0 : k;
  const i64 j = kk == 0 ? 0 : m - kk;
  const float ar = zr_b[kk], ai = zi_b[kk];
  const float br = zr_b[j], bi = zi_b[j];
  const float er = (ar + br) * 0.5f, ei = (ai - bi) * 0.5f;
  const float orr = (ai + bi) * 0.5f, oi = (br - ar) * 0.5f;
  float yr, yi;
  if (k == m) {
    yr = er - orr;
    yi = ei - oi;
  } else {
    const float c = wr[k], s = wi[k];
    yr = er + (orr * c - oi * s);
    yi = ei + (orr * s + oi * c);
  }
  const i64 o = b * (m + 1) + k;
  xr[o] = yr;
  xi[o] = yi;
}

__global__ void __launch_bounds__(THREADS)
    irfft_recomb_kernel(i64 m, int per_row, const float* xr, const float* xi,
                        const float* wr, const float* wi, float* zr,
                        float* zi) {
  const i64 b = blockIdx.x / per_row;
  const i64 k = (i64)(blockIdx.x % per_row) * THREADS + threadIdx.x;
  if (k >= m) return;
  const float* xr_b = xr + b * (m + 1);
  const float* xi_b = xi + b * (m + 1);
  const float ar = xr_b[k], ai = xi_b[k];
  const float br = xr_b[m - k], bi = xi_b[m - k];
  const float er = (ar + br) * 0.5f, ei = (ai - bi) * 0.5f;
  const float dr = (ar - br) * 0.5f, di = (ai + bi) * 0.5f;
  const float c = wr[k], s = wi[k];
  const float orr = dr * c - di * s, oi = dr * s + di * c;
  const i64 o = b * m + k;
  zr[o] = er - oi;
  zi[o] = ei + orr;
}

// Blocks of one launch: a row of `width` outputs takes ceil(width / THREADS).
static i64 recomb_grid(i64 B, i64 width, int* per_row) {
  if (B < 1 || width < 1) return -1;
  const i64 pr = (width + THREADS - 1) / THREADS;
  if (pr > 0x7fffffff) return -1;
  *per_row = (int)pr;
  const i64 blocks = B * pr;
  return blocks <= 0x7fffffff ? blocks : -1;
}

extern "C" int repro_rfft_recomb(i64 B, i64 m, const void* zr, const void* zi,
                                 const void* wr, const void* wi, void* xr,
                                 void* xi, void* stream) {
  int per_row = 0;
  const i64 blocks = recomb_grid(B, m + 1, &per_row);
  if (m < 1 || blocks < 1) return (int)cudaErrorInvalidValue;
  rfft_recomb_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      m, per_row, (const float*)zr, (const float*)zi, (const float*)wr,
      (const float*)wi, (float*)xr, (float*)xi);
  return (int)cudaGetLastError();
}

extern "C" int repro_irfft_recomb(i64 B, i64 m, const void* xr, const void* xi,
                                  const void* wr, const void* wi, void* zr,
                                  void* zi, void* stream) {
  int per_row = 0;
  const i64 blocks = recomb_grid(B, m, &per_row);
  if (m < 1 || blocks < 1) return (int)cudaErrorInvalidValue;
  irfft_recomb_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      m, per_row, (const float*)xr, (const float*)xi, (const float*)wr,
      (const float*)wi, (float*)zr, (float*)zi);
  return (int)cudaGetLastError();
}

static const KernelEntry ATTRS[] = {
    {"rfft_recomb_kernel", (const void*)&rfft_recomb_kernel},
    {"irfft_recomb_kernel", (const void*)&irfft_recomb_kernel},
};

extern "C" int repro_attrs_recomb(int i, const char** name, i64* regs,
                                  i64* local) {
  return kernel_attributes(ATTRS, 2, i, name, regs, local);
}
