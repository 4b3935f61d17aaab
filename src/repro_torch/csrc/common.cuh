// Definitions every kernel source shares (sm_90a): the 64-bit offset type,
// the block of the elementwise kernels, and the table of compiled
// attributes the register guard reads.
#pragma once

#include <cuda_runtime.h>

namespace repro {

// Offsets and sizes: B.n passes 2^31 at the main-path shapes.
typedef long long i64;

// Threads per block of the elementwise kernels (recomb.cu, bluestein_elem).
constexpr int THREADS = 256;

// Compiled attributes of the kernels of one source, for the register guard
// of chip_smoke.py: entry i of its table gives the kernel's name, its
// registers per thread and its local (spill) bytes per thread.  Returns -1
// past the table's end, else the cudaError_t of the query.
struct KernelEntry {
  const char* name;
  const void* fn;
};

inline int kernel_attributes(const KernelEntry* table, int count, int i,
                             const char** name, i64* regs, i64* local) {
  if (i < 0 || i >= count) return -1;
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, table[i].fn);
  if (err != cudaSuccess) return (int)err;
  *name = table[i].name;
  *regs = a.numRegs;
  *local = (i64)a.localSizeBytes;
  return 0;
}

}  // namespace repro
