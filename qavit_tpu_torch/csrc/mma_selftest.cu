// Self-test of the tensor-core primitives (mma.cuh): one warp loads a
// 16 x 16 bf16 A and a 16 x 16 bf16 B through ldmatrix and multiplies
// them with two mma_bf16_16816 calls (B's columns 0-7 and 8-15).  B is
// given [n][k] (ldmatrix, as the attention kernels read keys) or, with
// `trans`, [k][n] (ldmatrix.trans, as they read values and weights).
// Compared with A.float() @ B.float() on the card and, compiled against
// tests/cuda_emulation/qv_emulate.h, on the host
// (qavit_tpu_torch/kernels/mma_selftest.py).
#include "mma.cuh"

namespace qv {

struct MmaTestArgs {
  const void* a;    // [16, 16] bf16, row-major
  const void* b;    // [16, 16] bf16: [n][k], or [k][n] with trans
  float* d;         // [16, 16] float32 = a @ b
  int trans;
};

constexpr int MT_LD = 24;       // row stride in shared memory (48 bytes)

__global__ void __launch_bounds__(NTHREADS) mma_selftest_kernel(
    MmaTestArgs t) {
  QV_SMEM_DECL
  bf16* as = reinterpret_cast<bf16*>(qv_smem);
  bf16* bs = as + 16 * MT_LD;
  const bf16* a = static_cast<const bf16*>(t.a);
  const bf16* b = static_cast<const bf16*>(t.b);
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    as[(i / 16) * MT_LD + i % 16] = a[i];
    bs[(i / 16) * MT_LD + i % 16] = b[i];
  }
  __syncthreads();
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x, g = lane >> 2, q = lane & 3;
  unsigned af[4], bf[4];
  load_a(af, as, MT_LD, lane);
  if (t.trans)
    load_b_kn(bf, bs, MT_LD, lane);
  else
    load_b_nk(bf, bs, MT_LD, lane);
  float d0[4] = {0.f, 0.f, 0.f, 0.f}, d1[4] = {0.f, 0.f, 0.f, 0.f};
  mma_bf16_16816(d0, af, bf);
  mma_bf16_16816(d1, af, bf + 2);
  for (int i = 0; i < 4; ++i) {
    const int r = g + 8 * (i >> 1), c = 2 * q + (i & 1);
    t.d[r * 16 + c] = d0[i];
    t.d[r * 16 + 8 + c] = d1[i];
  }
}

}  // namespace qv

extern "C" int qv_mma_selftest(const qv::MmaTestArgs* a, void* stream) {
  return qv_launch(qv::mma_selftest_kernel, *a,
                   2 * 16 * qv::MT_LD * sizeof(qv::bf16), stream, 1);
}

extern "C" int qv_mma_selftest_struct_size() {
  return (int)sizeof(qv::MmaTestArgs);
}
