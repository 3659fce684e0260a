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
#include <cstdio>
#include <cstdlib>

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
struct alignas(16) uint4 { unsigned x, y, z, w; };
inline float __uint_as_float(unsigned u) { float f; std::memcpy(&f, &u, 4); return f; }
struct __nv_bfloat16 { uint16_t bits; };
inline float __bfloat162float(__nv_bfloat16 v) {
  uint32_t u = uint32_t(v.bits) << 16; float f; std::memcpy(&f, &u, 4); return f; }
inline __nv_bfloat16 __float2bfloat16(float f) {
  uint32_t u; std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {uint16_t((u >> 16) | 0x40)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {uint16_t(u >> 16)};
}

// --- the tensor-core primitives of qavit_tpu_torch/csrc/mma.cuh ----------
// A warp-collective call posts each lane's registers (or row address),
// meets the warp at one barrier and reads the other lanes' posts.  The
// posts alternate between two slots: a lane can only reuse a slot after
// the next call's barrier, which every lane reaches after its last read.
struct qv_emu_post { unsigned w[6]; const void* p; };
inline qv_emu_post qv_emu_posts[2][256];
inline thread_local unsigned qv_emu_turn = 0;

inline const qv_emu_post* qv_emu_exchange(const qv_emu_post& mine) {
  qv_emu_post* slot = qv_emu_posts[qv_emu_turn ^= 1u];
  slot[threadIdx.x] = mine;
  __syncwarp();
  return slot + (threadIdx.x & ~31u);
}

// a shared-memory address the card would take: 16-byte aligned, inside
// the block's shared memory
inline void qv_emu_check_smem(const void* p, const char* what) {
  const char* lo = reinterpret_cast<const char*>(qv_emu_smem_buf);
  const char* c = static_cast<const char*>(p);
  if (reinterpret_cast<uintptr_t>(p) % 16 != 0 || c < lo ||
      c + 16 > lo + sizeof(qv_emu_smem_buf)) {
    std::fprintf(stderr, "qv_emulate: %s address %p is not a 16-byte "
                 "aligned shared-memory address\n", what, p);
    std::abort();
  }
}

inline float qv_emu_half(unsigned v, int hi) {
  return __bfloat162float(__nv_bfloat16{uint16_t(hi ? v >> 16 : v)});
}

// mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32: the warp's A [16 x 16] and
// B [16 x 8] rebuilt from the lanes' fragments (layouts in mma.cuh); each
// lane computes its own four outputs, products summed exactly (double)
// and rounded once, as the tensor cores' wide accumulation does
inline void mma_bf16_16816(float d[4], const unsigned a[4],
                           const unsigned b[2]) {
  const qv_emu_post* w = qv_emu_exchange(
      qv_emu_post{{a[0], a[1], a[2], a[3], b[0], b[1]}, nullptr});
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  auto A = [&](int r, int k) {
    return qv_emu_half(w[(r & 7) * 4 + (k & 7) / 2].w[(r >> 3) + 2 * (k >> 3)],
                       k & 1);
  };
  auto B = [&](int k, int n) {
    return qv_emu_half(w[n * 4 + (k & 7) / 2].w[4 + (k >> 3)], k & 1);
  };
  for (int i = 0; i < 4; ++i) {
    const int r = g + 8 * (i >> 1), n = 2 * t + (i & 1);
    double s = d[i];
    for (int k = 0; k < 16; ++k) s += double(A(r, k)) * double(B(k, n));
    d[i] = float(s);
  }
}

// ldmatrix.x4 (.trans): lanes 8i..8i+7 post the rows of matrix i
inline void qv_emu_ldmatrix(unsigned r[4], const void* row, bool trans) {
  qv_emu_check_smem(row, "ldmatrix");
  const qv_emu_post* w = qv_emu_exchange(qv_emu_post{{}, row});
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int i = 0; i < 4; ++i) {
    const uint16_t* p0;
    const uint16_t* p1;
    int e0, e1;
    if (trans) {        // column g of rows 2t, 2t + 1
      p0 = static_cast<const uint16_t*>(w[8 * i + 2 * t].p);
      p1 = static_cast<const uint16_t*>(w[8 * i + 2 * t + 1].p);
      e0 = e1 = g;
    } else {            // row g, columns 2t, 2t + 1
      p0 = p1 = static_cast<const uint16_t*>(w[8 * i + g].p);
      e0 = 2 * t;
      e1 = 2 * t + 1;
    }
    r[i] = unsigned(p0[e0]) | (unsigned(p1[e1]) << 16);
  }
}
inline void ldmatrix_x4(unsigned r[4], const void* row) {
  qv_emu_ldmatrix(r, row, false);
}
inline void ldmatrix_x4_trans(unsigned r[4], const void* row) {
  qv_emu_ldmatrix(r, row, true);
}

// cp.async: a synchronous copy; commit and wait have nothing to do
inline void cp_async_16(void* smem, const void* gmem) {
  qv_emu_check_smem(smem, "cp.async destination");
  if (reinterpret_cast<uintptr_t>(gmem) % 16 != 0) {
    std::fprintf(stderr, "qv_emulate: cp.async source %p is not 16-byte "
                 "aligned\n", gmem);
    std::abort();
  }
  std::memcpy(smem, gmem, 16);
}
inline void cp_async_commit() {}
template <int N> inline void cp_async_wait() {}

inline unsigned pack_bf16x2(float lo, float hi) {
  return unsigned(__float2bfloat16(lo).bits) |
         (unsigned(__float2bfloat16(hi).bits) << 16);
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
