// Unit 1 of the fused block at n = 256 (qavit_v2_extreme_tin), forward
// (eval and train): norm1 + the SWA branch over 16 4x4 windows of a 16 x 16
// grid.
//
// Replaces the TPU kernel qavit_tpu/kernels/fused_pallas.py:190 fwd_call
// for the core `swa` (fused_kernels.py:75) at 256 tokens.  The windows are
// independent, so the n = 64 tensor-core body (window_mma.cuh, SWA at
// NS = 1) runs with SIDE 16: a tile of 64 rows is four windows, a quarter
// of a sample, gathered from and scattered back to the 16 x 16 grid; one
// block per SM walks the B x 4 tiles.  The masks are the [B nw, 16, ...]
// layouts' own (the tile's window is 4 tl + warp row, as at n = 64).  In
// training the gate's softmax of the bank-write partials spans a sample's
// 256 tokens, four tiles, so a pass over the output forms them
// (bank256_kernel, n256_ops.cuh), then the reduction and the compression
// (qv_bank_compress).  The backward at n = 256 is swa_bwd_mma_kernel<16>
// (unit_swa_bwd.cu).
#include "n256_ops.cuh"
#include "window_mma.cuh"

namespace qv {

template <bool TRAIN>
__global__ void __launch_bounds__(NTHREADS, 1)
    swa256_kernel(SwaMmaArgs m) {
  window_mma<WIN_SWA, 1, TRAIN, SwaMmaArgs, 16>(m);
}

static int swa256_forward(const SwaArgs* a, const void* qkv_w16,
                          const void* proj_w16, bool train, void* stream) {
  const Dims& d = a->d;
  if (!qv_n256(d) || d.grid > 4 * d.B) return ERR_ARGS;
  const SwaMmaArgs m{*a, static_cast<const bf16*>(qkv_w16),
                     static_cast<const bf16*>(proj_w16)};
  if (!train)
    return qv_launch(swa256_kernel<false>, m, SM_SMEM_BYTES, stream, d.grid);
  QV_TRY(qv_launch(swa256_kernel<true>, m, SM_SMEM_BYTES, stream, d.grid));
  return qv_bank256(static_cast<const bf16*>(a->out), a->bw, d, stream);
}

}  // namespace qv

// bf16 at n = 256 (qv_n256): `a` as for qv_unit_swa, the qkv and proj
// kernels rounded to bf16 beside it, d.grid blocks (at most a tile of 64
// rows each); the scratch is unused.  Eval; the train entry also writes
// the bank-write partials (d.grid slices of the samples).
extern "C" int qv_unit_swa_mma256(const qv::SwaArgs* a, const void* qkv_w16,
                                  const void* proj_w16, void*, int is_bf16,
                                  void* stream) {
  if (!is_bf16 || a->d.train) return qv::ERR_ARGS;
  return qv::swa256_forward(a, qkv_w16, proj_w16, false, stream);
}

extern "C" int qv_unit_swa_mma_train256(const qv::SwaArgs* a,
                                        const void* qkv_w16,
                                        const void* proj_w16, void*,
                                        int is_bf16, void* stream) {
  if (!is_bf16 || !a->d.train) return qv::ERR_ARGS;
  return qv::swa256_forward(a, qkv_w16, proj_w16, true, stream);
}

extern "C" int qv_unit_swa_mma256_smem(const qv::Dims*) {
  return qv::SM_SMEM_BYTES;
}
extern "C" int qv_unit_swa_mma_train256_smem(const qv::Dims*) {
  return qv::SM_SMEM_BYTES;
}
extern "C" int qv_unit_swa_mma256_scratch(const qv::Dims*) { return 0; }
extern "C" int qv_unit_swa_mma_train256_scratch(const qv::Dims*) { return 0; }
