// Host emulation of the CUDA built-ins the unit kernels
// (qavit_tpu_torch/csrc) use, so their source compiles with g++ for the
// CPU tests: each block runs as 256 std::threads with a std::barrier for
// __syncthreads, blocks run one after another, shared memory is one
// buffer filled with NaN bytes before every block (a read before a write
// shows up as a NaN), bf16 rounds to nearest even.
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
#include <thread>
#include <vector>
#include <atomic>

#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __restrict__ __restrict
#define __launch_bounds__(x)
#define __align__(x) alignas(x)
#define __shared__ static

struct qv_dim3 { unsigned x = 0, y = 0, z = 0; };
inline thread_local qv_dim3 threadIdx;
inline qv_dim3 blockIdx, blockDim, gridDim;
inline std::barrier<>* qv_emu_barrier = nullptr;
alignas(16) inline float qv_emu_smem_buf[232448 / 4];
#define QV_SMEM_DECL float* qv_smem = qv_emu_smem_buf;

inline void __syncthreads() { qv_emu_barrier->arrive_and_wait(); }
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

template <typename A>
static int qv_launch(void (*kernel)(A), const A& a, size_t smem, void*) {
  if (smem > sizeof(qv_emu_smem_buf)) return 1;
  const int nthreads = 256;
  blockDim.x = nthreads; gridDim.x = a.d.B;
  for (unsigned b = 0; b < gridDim.x; ++b) {
    blockIdx.x = b;
    std::memset(qv_emu_smem_buf, 0xff, sizeof(qv_emu_smem_buf));  // NaN garbage
    std::barrier<> bar(nthreads);
    qv_emu_barrier = &bar;
    std::vector<std::thread> ts;
    for (int t = 0; t < nthreads; ++t)
      ts.emplace_back([&, t] { threadIdx.x = t; kernel(a); });
    for (auto& th : ts) th.join();
  }
  return 0;
}
