// Warp-level tensor-core primitives for the bf16 kernels: mma.sync
// m16n8k16 (bf16 operands, float32 accumulation), ldmatrix, cp.async and
// bf16x2 packing, each a small function around inline PTX, and the
// fragment-address helpers built on them.  Under QV_EMULATE the host
// versions in tests/cuda_emulation/qv_emulate.h stand in for the PTX, so
// the tier-1 tests run the kernels' fragment indexing on the CPU.
//
// Fragment layouts (PTX ISA, "Matrix Fragments for mma.m16n8k16"), for
// lane l of a warp, g = l / 4, t = l % 4, each register two bf16 with the
// lower column in the lower half:
//   A [16 x 16] row-major: a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//                          a3 (g+8, 2t+8..)
//   B [16 x 8] (k x n):     b0 (k 2t..2t+1, n g), b1 (k 2t+8..2t+9, n g)
//   C [16 x 8] float32:     c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1)
// Two neighbouring C tiles (columns 8j.. and 8j+8..) rounded to bf16 are
// exactly the A fragment of the next product over those 16 columns:
// a0 = (c0, c1) and a1 = (c2, c3) of the first, a2, a3 of the second.
#pragma once
#include "common.cuh"

namespace qv {

#ifndef QV_EMULATE
// d += a @ b on one 16 x 8 tile (bf16 x bf16 -> float32)
__device__ __forceinline__ void mma_bf16_16816(float d[4], const unsigned a[4],
                                               const unsigned b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// four 8 x 8 bf16 matrices from shared memory: lanes 8i..8i+7 give the
// row addresses of matrix i (16-byte aligned); r[i] holds lane l's pair
// of row l / 4 (.trans: of column l / 4, rows 2(l % 4), 2(l % 4) + 1)
__device__ __forceinline__ void ldmatrix_x4(unsigned r[4], const void* row) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(row);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned r[4],
                                                  const void* row) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(row);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}

// 16 bytes global -> shared without passing through registers; both
// addresses 16-byte aligned
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// two floats rounded to nearest even bf16, lo in the lower half
__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}
#endif

// --- fragment addresses (lane l of the warp) -------------------------------

// A fragment of the 16 x 16 tile at `a` (row-major, leading dim ld)
__device__ __forceinline__ void load_a(unsigned r[4], const bf16* a, int ld,
                                       int lane) {
  ldmatrix_x4(r, a + (lane & 15) * ld + (lane >> 4) * 8);
}

// B fragments of two n8 tiles from `b` stored [n][k] (rows n0..n0+15,
// columns k0..k0+15, leading dim ld), as keys are: r[0..1] columns n0..,
// r[2..3] columns n0+8..
__device__ __forceinline__ void load_b_nk(unsigned r[4], const bf16* b,
                                          int ld, int lane) {
  ldmatrix_x4(r, b + ((lane & 7) + ((lane >> 4) << 3)) * ld +
                     ((lane >> 3) & 1) * 8);
}

// the same from `b` stored [k][n] (rows k0..k0+15, columns n0..n0+15), as
// values and row-major weights are: ldmatrix's transpose
__device__ __forceinline__ void load_b_kn(unsigned r[4], const bf16* b,
                                          int ld, int lane) {
  ldmatrix_x4_trans(r, b + ((lane & 7) + ((lane >> 3) & 1) * 8) * ld +
                           (lane >> 4) * 8);
}

// two bf16 at p (4-byte aligned)
__device__ __forceinline__ void store_bf16x2(bf16* p, unsigned v) {
  *reinterpret_cast<unsigned*>(p) = v;
}

// the lower and upper bf16 of a packed pair as floats (exact: a bf16 is
// the upper half of a float)
__device__ __forceinline__ float bf16x2_lo(unsigned v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float bf16x2_hi(unsigned v) {
  return __uint_as_float(v & 0xffff0000u);
}

}  // namespace qv
