// Host emulation of the CUDA built-ins the kernels (qavit_tpu_torch/csrc)
// use, so their source compiles with g++ for the CPU tests: each block
// runs as 256 std::threads with a std::barrier for __syncthreads and one
// per warp of 32 for __syncwarp and the warp shuffles, blocks run one
// after another, shared memory is one buffer filled with NaN bytes before
// every block (a read before a write shows up as a NaN), bf16 rounds to
// nearest even.
//
//   g++ -std=c++20 -O1 -shared -fPIC -DQV_EMULATE -x c++ \
//       -I tests/cuda_emulation qavit_tpu_torch/csrc/*.cu -o libqv_emu.so
#pragma once
#include <math.h>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <cstddef>
#include <barrier>
#include <memory>
#include <thread>
#include <vector>
#include <atomic>

#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __restrict__ __restrict
#define __launch_bounds__(...)
#define __align__(x) alignas(x)
#define __shared__ static

struct qv_dim3 { unsigned x = 0, y = 0, z = 0; };
inline thread_local qv_dim3 threadIdx;
inline qv_dim3 blockIdx, blockDim, gridDim;
inline std::barrier<>* qv_emu_barrier = nullptr;
inline std::barrier<>* qv_emu_warp_barrier[8] = {};
inline float qv_emu_shfl_buf[256];
alignas(16) inline float qv_emu_smem_buf[232448 / 4];
#define QV_SMEM_DECL float* qv_smem = qv_emu_smem_buf;

inline void __syncthreads() { qv_emu_barrier->arrive_and_wait(); }
// every lane of the warp must take part, as `mask` 0xffffffff says on the card
inline void __syncwarp(unsigned = 0xffffffffu) {
  qv_emu_warp_barrier[threadIdx.x / 32]->arrive_and_wait();
}
inline float __shfl_xor_sync(unsigned, float v, int lane_mask) {
  qv_emu_shfl_buf[threadIdx.x] = v;
  __syncwarp();
  const float r = qv_emu_shfl_buf[(threadIdx.x & ~31u) |
                                  ((threadIdx.x & 31u) ^ unsigned(lane_mask))];
  __syncwarp();
  return r;
}
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }
inline int atomicAdd(int* p, int v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
inline int atomicOr(int* p, int v) { return __atomic_fetch_or(p, v, __ATOMIC_SEQ_CST); }
inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }
using std::isnan;
struct alignas(16) float4 { float x, y, z, w; };
struct __nv_bfloat16 { uint16_t bits; };
inline float __bfloat162float(__nv_bfloat16 v) {
  uint32_t u = uint32_t(v.bits) << 16; float f; std::memcpy(&f, &u, 4); return f; }
inline __nv_bfloat16 __float2bfloat16(float f) {
  uint32_t u; std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {uint16_t((u >> 16) | 0x40)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {uint16_t(u >> 16)};
}

// Run `body` as `grid` blocks of 256 threads, one block after another.
template <typename F>
static int qv_emu_run(int grid, F body) {
  const int nthreads = 256;
  blockDim.x = nthreads; gridDim.x = grid;
  for (unsigned b = 0; b < gridDim.x; ++b) {
    blockIdx.x = b;
    std::memset(qv_emu_smem_buf, 0xff, sizeof(qv_emu_smem_buf));  // NaN garbage
    std::barrier<> bar(nthreads);
    qv_emu_barrier = &bar;
    std::vector<std::unique_ptr<std::barrier<>>> warps;
    for (int w = 0; w < nthreads / 32; ++w) {
      warps.push_back(std::make_unique<std::barrier<>>(32));
      qv_emu_warp_barrier[w] = warps.back().get();
    }
    std::vector<std::thread> ts;
    for (int t = 0; t < nthreads; ++t)
      ts.emplace_back([&, t] { threadIdx.x = t; body(); });
    for (auto& th : ts) th.join();
  }
  return 0;
}

// A unit kernel on `grid` blocks (the card's qv_launch).
template <typename A>
static int qv_launch(void (*kernel)(A), const A& a, size_t smem, void*,
                     int grid) {
  if (smem > sizeof(qv_emu_smem_buf)) return 1;
  return qv_emu_run(grid, [&] { kernel(a); });
}
