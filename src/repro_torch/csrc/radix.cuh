// Shared-memory Stockham FFT engine of the radix kernels (sm_90a).
//
// Counterpart of the reference's radix-2 Stockham autosort FFT
// (src/repro/core/fft_xla.py:114, stockham_fft), written as the paper
// writes its kernel: a butterfly FFT kept on chip, each point crossing
// device memory once each way, the twiddles read from one table through
// the read-only ("texture") path.  dft_matmul.cu, fft4step.cu, pencil.cu
// (cols_pass, rows_natural, cols_natural) and bluestein.cu (the fused
// stages) run it.
//
// A block transforms a tile of M = T * E points: C = 2^lgc signals of
// length L = 2^lgl (C * L = M).  Each thread holds E points in registers.
// A length-L transform is a radix-2 or radix-4 stage (when log2 L is not a
// multiple of 3) followed by radix-8 stages, in Stockham order: stage with
// span Ns (the product of the radices before it) takes butterfly jj's R
// inputs at jj + r * L/R, multiplies input r by w^(k*r) with k = jj mod Ns
// and w = e^(-+2 pi i / (Ns * R)), runs an R-point DFT in registers and
// writes output r to (jj - k) * R + k + r * Ns.  After the last stage the
// outputs sit in natural order.  Between stages the points exchange through
// a shared-memory buffer (one plane each for re and im, padded by one word
// in 32 so that most strided writes of the early stages do not conflict on
// banks); the first stage reads device memory through a load policy and
// the last writes it through a store policy, or into the buffer for a
// store that needs another order (stage_out).
//
// Every twiddle, inner root and inter-factor phasor comes from the one
// table of n-th roots w_n^k = e^(-+2 pi i k / n) (k < n, conjugated for the
// inverse): the stage twiddle w_(Ns R)^k of a length-L transform with
// L | n is w_n^(k n / (Ns R)), and its powers r < R are products of it.
// The R-point DFTs' own rotations by +-i and (1 +- i)/sqrt 2 take their
// sign from the table (w_n^(n/4) = -+i).
//
// Register arrays are indexed by compile-time constants only (every loop
// over them unrolls), so nothing spills to local memory.
#pragma once

#include "common.cuh"

namespace repro {

// A read of a table the kernel never writes: the read-only data path.
__device__ __forceinline__ float ldro(const float* p) {
#ifdef __CUDA_ARCH__
  return __ldg(p);
#else
  return *p;
#endif
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmulf(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
// a * (s i): a rotation by a quarter turn, s = -1 forward, +1 inverse.
__device__ __forceinline__ float2 crot(float2 a, float s) {
  return make_float2(-s * a.y, s * a.x);
}

// log2 of a power of two, else -1.
inline int log2_exact(i64 v) {
  if (v < 1) return -1;
  int lg = 0;
  while ((1LL << lg) < v) ++lg;
  return (1LL << lg) == v ? lg : -1;
}

// Words of one plane of the exchange buffer for a tile of m points.
__host__ __device__ constexpr i64 xwords(i64 m) { return m + (m >> 5); }

// Shared memory of the exchange buffer (both planes) for m points.
__host__ __device__ constexpr i64 radix_smem_bytes(i64 m) {
  return 2 * xwords(m) * (i64)sizeof(float);
}

// A tile's shape: C = 2^lgc signals of L = 2^lgl points.  sig_fast: the
// signals are the unit-stride axis of the tile's device memory (columns of
// a matrix), so consecutive threads walk signals, and the exchange buffer
// keeps them adjacent; else consecutive threads walk positions.
struct Geo {
  int lgl;
  int lgc;
  bool sig_fast;
};

// (signal, position) -> word of the exchange buffer.
__device__ __forceinline__ int xaddr(const Geo& g, int sig, int pos) {
  const int a = g.sig_fast ? (pos << g.lgc) + sig : (sig << g.lgl) + pos;
  return a + (a >> 5);
}

// (signal, bin) -> word of the stage_out buffer: positions adjacent, one pad
// word per 2^lgp (a store that reads it with a stride of 2^lgp is free of
// bank conflicts).
__device__ __forceinline__ int oaddr(const Geo& g, int lgp, int sig, int bin) {
  const int a = (sig << g.lgl) + bin;
  return a + (a >> lgp);
}

// Butterfly j of a radix-2^lgr stage -> (signal, jj < L/R).
__device__ __forceinline__ void split(const Geo& g, int lgr, int j, int& sig, int& jj) {
  if (g.sig_fast) {
    sig = j & ((1 << g.lgc) - 1);
    jj = j >> g.lgc;
  } else {
    const int lgq = g.lgl - lgr;
    jj = j & ((1 << lgq) - 1);
    sig = j >> lgq;
  }
}

// R-point DFTs in registers, natural order in and out; s = -1 forward.
template <int R>
__device__ __forceinline__ void dft(float2* v, float s);

template <>
__device__ __forceinline__ void dft<2>(float2* v, float) {
  const float2 a = v[0];
  v[0] = cadd(a, v[1]);
  v[1] = csub(a, v[1]);
}

template <>
__device__ __forceinline__ void dft<4>(float2* v, float s) {
  const float2 p02 = cadd(v[0], v[2]), m02 = csub(v[0], v[2]);
  const float2 p13 = cadd(v[1], v[3]), t = crot(csub(v[1], v[3]), s);
  v[0] = cadd(p02, p13);
  v[2] = csub(p02, p13);
  v[1] = cadd(m02, t);
  v[3] = csub(m02, t);
}

template <>
__device__ __forceinline__ void dft<8>(float2* v, float s) {
  const float c = 0.70710678118654752f;  // cos(pi / 4)
  float2 e[4] = {v[0], v[2], v[4], v[6]};
  float2 o[4] = {v[1], v[3], v[5], v[7]};
  dft<4>(e, s);
  dft<4>(o, s);
  // o[k] *= w_8^k: (c, s c), (0, s), (-c, s c).
  o[1] = make_float2(c * (o[1].x - s * o[1].y), c * (s * o[1].x + o[1].y));
  o[2] = crot(o[2], s);
  o[3] = make_float2(-c * (o[3].x + s * o[3].y), c * (s * o[3].x - o[3].y));
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[k] = cadd(e[k], o[k]);
    v[k + 4] = csub(e[k], o[k]);
  }
}

// The roots table and the direction it encodes.
struct Roots {
  const float* re;
  const float* im;
  int lgn;  // log2 of the table's length
  float s;  // -1 forward, +1 inverse
  __device__ __forceinline__ float2 operator()(int k) const {
    return make_float2(ldro(re + k), ldro(im + k));
  }
};

__device__ __forceinline__ Roots roots_table(const float* re, const float* im, int lgn) {
  // w_n^(n/4) = -+i; below n = 4 only radix-2 stages run and s is unused.
  const float s = lgn >= 2 ? ldro(im + (1 << (lgn - 2))) : -1.f;
  return Roots{re, im, lgn, s};
}

// Input r of a butterfly times w^r, w = the table's entry i: one table
// read per butterfly, the other powers as products of at most three (a
// few ulp).  In the middle stages the 32 lanes of a warp read 32 entries a
// stride apart, so each read costs a sector per lane: reading w^2 and w^4
// as well took a fifth of the time at n = 16384 on the H100.
template <int R>
__device__ __forceinline__ void twiddle(float2* v, const Roots& w, int i);

template <>
__device__ __forceinline__ void twiddle<2>(float2* v, const Roots& w, int i) {
  v[1] = cmulf(v[1], w(i));
}

template <>
__device__ __forceinline__ void twiddle<4>(float2* v, const Roots& w, int i) {
  const float2 w1 = w(i), w2 = cmulf(w1, w1);
  v[1] = cmulf(v[1], w1);
  v[2] = cmulf(v[2], w2);
  v[3] = cmulf(v[3], cmulf(w1, w2));
}

template <>
__device__ __forceinline__ void twiddle<8>(float2* v, const Roots& w, int i) {
  const float2 w1 = w(i);
  const float2 w2 = cmulf(w1, w1);
  const float2 w4 = cmulf(w2, w2);
  const float2 w3 = cmulf(w1, w2);
  v[1] = cmulf(v[1], w1);
  v[2] = cmulf(v[2], w2);
  v[3] = cmulf(v[3], w3);
  v[4] = cmulf(v[4], w4);
  v[5] = cmulf(v[5], cmulf(w1, w4));
  v[6] = cmulf(v[6], cmulf(w2, w4));
  v[7] = cmulf(v[7], cmulf(w3, w4));
}

// One Stockham stage of radix R = 2^LGR and span Ns = 2^lgns over the
// tile.  first: inputs from ld(sig, pos, v); else from the exchange buffer.
// last: outputs to st(sig, bin, v), or with lgp >= 0 into the stage_out
// buffer; else into the exchange buffer.
template <int T, int E, int LGR, class LD, class ST>
__device__ __forceinline__ void radix_stage(float2 (&v)[E], const Geo& g, int lgns, bool first,
                                            bool last, int lgp, const Roots& w, float* xre,
                                            float* xim, const LD& ld, const ST& st) {
  constexpr int R = 1 << LGR;
  constexpr int NB = E / R;  // butterflies per thread
  const int lgq = g.lgl - LGR;
  const int tid = threadIdx.x;
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    int sig, jj;
    split(g, LGR, tid + b * T, sig, jj);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int pos = jj + (r << lgq);
      if (first) {
        ld(sig, pos, v[b * R + r]);
      } else {
        const int a = xaddr(g, sig, pos);
        v[b * R + r] = make_float2(xre[a], xim[a]);
      }
    }
  }
  const int ts = w.lgn - lgns - LGR;  // table stride of w_(Ns R)
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    if (lgns > 0) {
      int sig, jj;
      split(g, LGR, tid + b * T, sig, jj);
      twiddle<R>(&v[b * R], w, (jj & ((1 << lgns) - 1)) << ts);
    }
    dft<R>(&v[b * R], w.s);
  }
  if (last && lgp < 0) {
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      int sig, jj;
      split(g, LGR, tid + b * T, sig, jj);
#pragma unroll
      for (int r = 0; r < R; ++r) st(sig, jj + (r << lgq), v[b * R + r]);
    }
    return;
  }
  __syncthreads();  // every thread has read this stage's inputs
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    int sig, jj;
    split(g, LGR, tid + b * T, sig, jj);
    const int k = jj & ((1 << lgns) - 1);
    const int o = ((jj >> lgns) << (lgns + LGR)) + k;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int a = last ? oaddr(g, lgp, sig, o + (r << lgns)) : xaddr(g, sig, o + (r << lgns));
      xre[a] = v[b * R + r].x;
      xim[a] = v[b * R + r].y;
    }
  }
  __syncthreads();  // the next stage's inputs are in place
}

// The whole length-L transform of the tile's C signals by all T threads of
// the block.  xre / xim: the exchange buffer, xwords(T * E) words each.
// lgp < 0: the last stage stores through st; lgp >= 0: it leaves bin k of
// signal c at oaddr(g, lgp, c, k) of the buffer, after a block barrier.
template <int T, int E, class LD, class ST>
__device__ __forceinline__ void radix_fft(const Geo& g, const Roots& w, float* xre, float* xim,
                                          const LD& ld, const ST& st, int lgp = -1) {
  float2 v[E];
  const int tail = g.lgl % 3;
  const int n8 = g.lgl / 3;
  if (g.lgl == 0) {  // length 1: the transform is the identity
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int sig = threadIdx.x + e * T;
      ld(sig, 0, v[e]);
      st(sig, 0, v[e]);
    }
    return;
  }
  int lgns = 0;
  if (tail == 1) {
    radix_stage<T, E, 1>(v, g, lgns, true, n8 == 0, lgp, w, xre, xim, ld, st);
    lgns = 1;
  } else if (tail == 2) {
    radix_stage<T, E, 2>(v, g, lgns, true, n8 == 0, lgp, w, xre, xim, ld, st);
    lgns = 2;
  }
  for (int i = 0; i < n8; ++i) {
    radix_stage<T, E, 3>(v, g, lgns, lgns == 0, i == n8 - 1, lgp, w, xre, xim, ld, st);
    lgns += 3;
  }
}

// Contiguous signals of a (B, n) plane pair: signal c of the tile is the
// c-th row from xr / xi (the tile's first), of which only the first cv
// exist (a ragged last tile).  Offsets within a tile fit 32 bits.
struct RowLoad {
  const float* xr;
  const float* xi;
  int lgl;
  int cv;
  __device__ __forceinline__ void operator()(int sig, int pos, float2& v) const {
    if (sig >= cv) {
      v = make_float2(0.f, 0.f);
      return;
    }
    const int off = (sig << lgl) + pos;
    v = make_float2(xr[off], xi[off]);
  }
};

// The natural-order store of contiguous signals: bin k of the tile's c-th
// row, times the scale and, when er != nullptr, the phasor e[k].
struct RowStore {
  float* yr;
  float* yi;
  int lgl;
  int cv;
  float scale;
  const float* er;
  const float* ei;
  __device__ __forceinline__ void operator()(int sig, int bin, float2 v) const {
    if (sig >= cv) return;
    v = make_float2(v.x * scale, v.y * scale);
    if (er != nullptr) v = cmulf(v, make_float2(ldro(er + bin), ldro(ei + bin)));
    const int off = (sig << lgl) + bin;
    yr[off] = v.x;
    yi[off] = v.y;
  }
};

// The store of a stage_out transform: nothing through the policy.
struct NoStore {
  __device__ __forceinline__ void operator()(int, int, float2) const {}
};

// The whole-signal tiles: threads per block and the blocks each SM must
// hold (at most 64 registers a thread, none spilled), by log2 of the tile.
// 4096 points: 256 threads of 16, four blocks; 8192: 512 of 16, two;
// 16384: 1024 of 16, one (the signal fills half the register file).
constexpr int T12 = 256, MB12 = 4;
constexpr int T13 = 512, MB13 = 2;
constexpr int T14 = 1024, MB14 = 1;

// The slab kernels' tile: 8192 points, 1024 threads of 8, one block an SM
// (64 registers, none spilled; 16 points a thread spill here).
constexpr int SL_T = 1024;
constexpr int SL_LGM = 13;
constexpr int SL_E = (1 << SL_LGM) / SL_T;

// Column j2 = c0 + c of one signal's (n1, n2) row-major matrix.
struct ColLoad {
  const float* xr;
  const float* xi;
  int lg2;
  int c0;
  int cv;
  __device__ __forceinline__ void operator()(int sig, int pos, float2& v) const {
    if (sig >= cv) {
      v = make_float2(0.f, 0.f);
      return;
    }
    const int off = (pos << lg2) + c0 + sig;
    v = make_float2(xr[off], xi[off]);
  }
};

// Bin k1 of column j2 = c0 + c, times w_n^(k1 j2), to the slab's (k1, j2).
struct ColStore {
  float* mr;
  float* mi;
  int lg2;
  int c0;
  int cv;
  Roots w;
  __device__ __forceinline__ void operator()(int sig, int bin, float2 v) const {
    if (sig >= cv) return;
    const int j2 = c0 + sig;
    v = cmulf(v, w(bin * j2));  // k1 j2 < n1 n2: no wrap
    const int off = (bin << lg2) + j2;
    mr[off] = v.x;
    mi[off] = v.y;
  }
};

// Output position p of a signal (at yr / yi + off), times the scale and
// the phasor e[p].
__device__ __forceinline__ void put(float* yr, float* yi, int off, int p, float2 v, float scale,
                                    const float* er, const float* ei) {
  v = make_float2(v.x * scale, v.y * scale);
  if (er != nullptr) v = cmulf(v, make_float2(ldro(er + p), ldro(ei + p)));
  yr[off] = v.x;
  yi[off] = v.y;
}

}  // namespace repro
