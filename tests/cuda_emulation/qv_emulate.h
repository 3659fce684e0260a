// Host emulation of the CUDA built-ins the kernels (qavit_tpu_torch/csrc)
// use, so their source compiles with g++ for the CPU tests: each block
// runs as 256 std::threads with a std::barrier for __syncthreads and one
// per warp of 32 for __syncwarp and the warp shuffles, blocks run one
// after another, shared memory is one buffer filled with NaN bytes before
// every block (a read before a write shows up as a NaN), bf16 rounds to
// nearest even.  A cluster launch (csrc/cluster.cuh) runs the CTAs of one
// cluster at once, each with its own NaN-filled shared memory, one
// std::barrier over all their threads for the cluster barrier, and the
// clusters one after another; a CTA's read of its partner's shared memory
// (cluster_peer) sees a copy taken when the partner last arrived at the
// cluster barrier, so a read that no barrier orders after the partner's
// write shows the NaN fill (or the partner's rows of an earlier pass).
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
#include <optional>

#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __restrict__ __restrict
#define __launch_bounds__(...)
#define __align__(x) alignas(x)
#define __shared__ static

struct qv_dim3 { unsigned x = 0, y = 0, z = 0; };
inline thread_local qv_dim3 threadIdx, blockIdx;
inline qv_dim3 blockDim, gridDim;

// The state of one CTA: its barriers, its warps' exchange buffers and its
// shared memory.  A plain launch runs one CTA at a time, a cluster launch
// QV_EMU_CTAS at most.
constexpr int QV_EMU_CTAS = 2;
constexpr size_t QV_EMU_SMEM = 232448;
struct qv_emu_post { unsigned w[6]; const void* p; };
struct qv_emu_cta {
  std::barrier<>* bar = nullptr;
  std::barrier<>* warp_bar[8] = {};
  float shfl[256];
  qv_emu_post posts[2][256];
  alignas(16) float smem[QV_EMU_SMEM / 4];
  alignas(16) float seen[2][QV_EMU_SMEM / 4];  // as at the last arrivals
};
inline qv_emu_cta qv_emu_ctas[QV_EMU_CTAS];
inline thread_local qv_emu_cta* qv_emu_me = &qv_emu_ctas[0];
inline thread_local unsigned qv_emu_rank = 0;     // in the cluster
#define QV_SMEM_DECL float* qv_smem = qv_emu_me->smem;

inline void __syncthreads() { qv_emu_me->bar->arrive_and_wait(); }
// every lane of the warp must take part, as `mask` 0xffffffff says on the card
inline void __syncwarp(unsigned = 0xffffffffu) {
  qv_emu_me->warp_bar[threadIdx.x / 32]->arrive_and_wait();
}
inline float __shfl_xor_sync(unsigned, float v, int lane_mask) {
  float* buf = qv_emu_me->shfl;
  buf[threadIdx.x] = v;
  __syncwarp();
  const float r = buf[(threadIdx.x & ~31u) |
                      ((threadIdx.x & 31u) ^ unsigned(lane_mask))];
  __syncwarp();
  return r;
}
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }
inline int atomicAdd(int* p, int v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
inline int atomicOr(int* p, int v) { return __atomic_fetch_or(p, v, __ATOMIC_SEQ_CST); }
inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }
using std::isnan;
struct alignas(8) float2 { float x, y; };
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
inline thread_local unsigned qv_emu_turn = 0;

inline const qv_emu_post* qv_emu_exchange(const qv_emu_post& mine) {
  qv_emu_post* slot = qv_emu_me->posts[qv_emu_turn ^= 1u];
  slot[threadIdx.x] = mine;
  __syncwarp();
  return slot + (threadIdx.x & ~31u);
}

// a shared-memory address the card would take: 16-byte aligned, inside
// the block's shared memory
inline void qv_emu_check_smem(const void* p, const char* what) {
  const char* lo = reinterpret_cast<const char*>(qv_emu_me->smem);
  const char* c = static_cast<const char*>(p);
  if (reinterpret_cast<uintptr_t>(p) % 16 != 0 || c < lo ||
      c + 16 > lo + QV_EMU_SMEM) {
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

// --- thread-block clusters (csrc/cluster.cuh) ----------------------------
// Arriving at the cluster barrier, a CTA first meets its own threads and
// copies its shared memory to seen[parity of the arrival]; a thread that
// has waited for the arrival reads its partner's copy of that parity, so
// the partner may run on to its next arrival (into the other copy), and
// no further: it waits for this CTA's next arrival first.  A pointer from
// cluster_peer holds until the thread's next cluster_wait.
struct qv_emu_publish {
  qv_emu_cta* cta;
  unsigned* arrivals;
  void operator()() noexcept {
    std::memcpy(cta->seen[++*arrivals & 1u], cta->smem, QV_EMU_SMEM);
  }
};
inline std::barrier<qv_emu_publish>* qv_emu_publish_bar[QV_EMU_CTAS] = {};
inline std::barrier<>* qv_emu_cluster_bar = nullptr;
inline thread_local unsigned qv_emu_waited = 0;    // arrivals waited for
inline thread_local std::optional<std::barrier<>::arrival_token>
    qv_emu_token;

namespace qv {
inline unsigned cluster_rank() { return qv_emu_rank; }
inline void cluster_arrive() {
  qv_emu_publish_bar[qv_emu_rank]->arrive_and_wait();
  qv_emu_token.emplace(qv_emu_cluster_bar->arrive());
}
inline void cluster_wait() {
  qv_emu_cluster_bar->wait(std::move(*qv_emu_token));
  qv_emu_token.reset();
  ++qv_emu_waited;
}
template <typename T>
inline const T* cluster_peer(const T* p, unsigned rank) {
  const char* c = reinterpret_cast<const char*>(p);
  const char* lo = reinterpret_cast<const char*>(qv_emu_me->smem);
  if (c < lo || c >= lo + QV_EMU_SMEM) {
    std::fprintf(stderr, "qv_emulate: cluster_peer of %p, not a shared-"
                 "memory address\n", static_cast<const void*>(p));
    std::abort();
  }
  const char* seen = reinterpret_cast<const char*>(
      qv_emu_ctas[rank].seen[qv_emu_waited & 1u]);
  return reinterpret_cast<const T*>(seen + (c - lo));
}
}  // namespace qv

// Run `body` as `grid` clusters of `csize` CTAs of 256 threads, the CTAs
// of a cluster at once (blocks csize c ..), the clusters one after
// another; csize 1 is a plain launch.
template <typename F>
static int qv_emu_run(int grid, F body, int csize = 1) {
  const int nthreads = 256;
  blockDim.x = nthreads; gridDim.x = grid * csize;
  for (int c = 0; c < grid; ++c) {
    std::vector<std::unique_ptr<std::barrier<>>> bars;
    std::vector<std::unique_ptr<std::barrier<qv_emu_publish>>> pubs;
    unsigned arrivals[QV_EMU_CTAS] = {};
    std::barrier<> cluster(csize * nthreads);
    qv_emu_cluster_bar = &cluster;
    for (int r = 0; r < csize; ++r) {
      qv_emu_cta& cta = qv_emu_ctas[r];
      std::memset(cta.smem, 0xff, sizeof(cta.smem));   // NaN garbage
      std::memset(cta.seen, 0xff, sizeof(cta.seen));
      bars.push_back(std::make_unique<std::barrier<>>(nthreads));
      cta.bar = bars.back().get();
      for (int w = 0; w < nthreads / 32; ++w) {
        bars.push_back(std::make_unique<std::barrier<>>(32));
        cta.warp_bar[w] = bars.back().get();
      }
      pubs.push_back(std::make_unique<std::barrier<qv_emu_publish>>(
          nthreads, qv_emu_publish{&cta, &arrivals[r]}));
      qv_emu_publish_bar[r] = pubs.back().get();
    }
    std::vector<std::thread> ts;
    for (int r = 0; r < csize; ++r)
      for (int t = 0; t < nthreads; ++t)
        ts.emplace_back([&, r, t] {
          threadIdx.x = t;
          blockIdx.x = c * csize + r;
          qv_emu_me = &qv_emu_ctas[r];
          qv_emu_rank = r;
          qv_emu_waited = 0;
          qv_emu_turn = 0;
          body();
        });
    for (auto& th : ts) th.join();
  }
  return 0;
}

// A unit kernel on `grid` blocks (the card's qv_launch).
template <typename A>
static int qv_launch(void (*kernel)(A), const A& a, size_t smem, void*,
                     int grid) {
  if (smem > QV_EMU_SMEM) return 1;
  return qv_emu_run(grid, [&] { kernel(a); });
}

// A unit kernel on `clusters` clusters of `csize` CTAs (the card's
// qv_launch_cluster).
template <typename A>
static int qv_launch_cluster(void (*kernel)(A), const A& a, size_t smem,
                             void*, int clusters, int csize) {
  if (smem > QV_EMU_SMEM || csize > QV_EMU_CTAS) return 1;
  return qv_emu_run(clusters, [&] { kernel(a); }, csize);
}
