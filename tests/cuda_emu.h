// Runs the CUDA subset that limo_tpu_torch/csrc/assemble.cu uses on the CPU,
// so that the kernels' own code can be tested where there is no card and no
// nvcc (tests/test_torch_cuda.py::test_kernel_source_emulated_on_cpu).
//
// One std::thread per CUDA thread; the blocks of a launch run one after
// another. __syncthreads is a barrier of the block, __syncwarp and the
// shuffles a barrier of the warp, atomics and fences the C++ ones. The test
// rewrites `extern __shared__` and the `<<<...>>>` launches before compiling.
// It emulates semantics, not timing or the memory model's weaker orders.
#pragma once
#include <math.h>

#include <algorithm>
#include <atomic>
#include <barrier>
#include <cstddef>
#include <functional>
#include <memory>
#include <thread>
#include <vector>

using std::max;
using std::min;

struct dim3u {
  unsigned x = 0, y = 1, z = 1;
};
inline thread_local dim3u threadIdx, blockIdx;
inline dim3u blockDim, gridDim;

struct float4 {
  float x, y, z, w;
};

typedef void* cudaStream_t;
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline int cudaFuncSetAttribute(const void*, int, int) { return 0; }
inline int cudaGetDevice(int* device) {
  *device = 0;
  return 0;
}
inline int cudaGetLastError() { return 0; }

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __shared__ static  // blocks run one at a time

struct EmuBlock {
  std::unique_ptr<std::barrier<>> block;
  std::vector<std::unique_ptr<std::barrier<>>> warps;
  std::vector<float> lanes;  // one slot per thread for the shuffles
  std::vector<float4> smem;  // dynamic shared memory, 16-byte aligned
};
inline EmuBlock* emu_block = nullptr;

inline float* emu_dyn_smem() { return reinterpret_cast<float*>(emu_block->smem.data()); }
inline void __syncthreads() { emu_block->block->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  emu_block->warps[threadIdx.x >> 5]->arrive_and_wait();
}
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }

inline float __shfl_xor_sync(unsigned, float v, int off) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* lanes = emu_block->lanes.data() + 32 * warp;
  lanes[lane] = v;
  __syncwarp();
  const float r = lanes[lane ^ off];
  __syncwarp();
  return r;
}

inline unsigned atomicAdd(unsigned* p, unsigned v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline float __ldg(const float* p) { return *p; }
template <class T>
inline T __ldcg(const T* p) {
  return *p;
}

inline void emu_run(int grid, int threads, size_t smem_bytes, std::function<void()> body) {
  gridDim.x = grid;
  blockDim.x = threads;
  for (int b = 0; b < grid; ++b) {
    EmuBlock blk;
    blk.block = std::make_unique<std::barrier<>>(threads);
    for (int w = 0; w < threads / 32; ++w) blk.warps.push_back(std::make_unique<std::barrier<>>(32));
    blk.lanes.assign(threads, 0.0f);
    blk.smem.assign(smem_bytes / sizeof(float4) + 1, float4{NAN, NAN, NAN, NAN});
    emu_block = &blk;
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; ++t)
      ts.emplace_back([=]() {
        threadIdx.x = t;
        blockIdx.x = b;
        body();
      });
    for (auto& t : ts) t.join();
  }
  emu_block = nullptr;
}

// kernel<<<grid, threads, smem, stream>>>(args) is rewritten as
// emu_launcher(kernel, grid, threads, smem, stream)(args).
template <class F>
auto emu_launcher(F kernel, int grid, int threads, size_t smem_bytes, cudaStream_t) {
  return [=](auto... args) { emu_run(grid, threads, smem_bytes, [=]() { kernel(args...); }); };
}
