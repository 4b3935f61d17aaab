// Host emulation of the CUDA runtime subset the port's kernels use, so the
// CUDA sources compile with a host C++20 compiler and run on the CPU in
// tests (tests/test_torch_emulated.py).
//
// A launch runs its blocks one at a time; the block's threads are
// std::threads, __syncthreads is a std::barrier, static __shared__ arrays
// are function-local statics and dynamic shared memory is one buffer per
// launch.  The test rewrites `k<<<grid, block, smem, stream>>>(args)` to
// `emu_launch(k, grid, block, smem, stream, args)` and
// `extern __shared__ float2 smem[];` to the dynamic buffer before
// compiling.  Nothing here models warps, so code that relies on warp
// synchrony would not be checked by it (the kernels use none).
#pragma once
#include <barrier>
#include <cmath>
#include <cstddef>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static

struct float2 {
  float x, y;
};
inline float2 make_float2(float x, float y) { return float2{x, y}; }
struct dim3 {
  unsigned x = 0, y = 0, z = 0;
};
inline thread_local dim3 threadIdx;
inline dim3 blockIdx;
inline std::barrier<>* emu_barrier = nullptr;
inline float2* emu_dyn_smem = nullptr;
inline void __syncthreads() { emu_barrier->arrive_and_wait(); }

typedef void* cudaStream_t;
enum cudaError_t {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorLaunchOutOfResources = 7
};
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
// The H100's per-block opt-in shared memory.
constexpr size_t EMU_SMEM_OPTIN = 232448;
inline int emu_error = 0;
inline cudaError_t cudaGetLastError() {
  int e = emu_error;
  emu_error = 0;
  return (cudaError_t)e;
}
inline const char* cudaGetErrorString(cudaError_t e) {
  return e == cudaSuccess ? "no error" : "emulated launch error";
}
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int bytes) {
  return (size_t)bytes > EMU_SMEM_OPTIN ? cudaErrorInvalidValue : cudaSuccess;
}
// A host build has no registers or local memory to report: zeros.
struct cudaFuncAttributes {
  int numRegs = 0;
  size_t localSizeBytes = 0;
};
inline cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* a, const void*) {
  *a = cudaFuncAttributes{};
  return cudaSuccess;
}

template <class K, class... A>
void emu_launch(K kernel, unsigned grid, int block, size_t smem, cudaStream_t,
                A... args) {
  if (smem > EMU_SMEM_OPTIN) {
    emu_error = cudaErrorLaunchOutOfResources;
    return;
  }
  std::vector<float2> dyn(smem / sizeof(float2) + 1);
  emu_dyn_smem = dyn.data();
  std::barrier<> bar(block);
  emu_barrier = &bar;
  std::vector<std::thread> threads;
  for (int t = 0; t < block; ++t)
    threads.emplace_back([&, t] {
      threadIdx.x = t;
      for (unsigned b = 0; b < grid; ++b) {
        if (t == 0) blockIdx.x = b;
        bar.arrive_and_wait();
        kernel(args...);
        bar.arrive_and_wait();
      }
    });
  for (auto& th : threads) th.join();
}
