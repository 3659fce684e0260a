// Unit 1 of the fused block, forward (eval and train): norm1 LayerNorm +
// SWA branch.
//
// Replaces the TPU unit qavit_tpu/kernels/fused_kernels.py
// make_cores.core_swa (fused_cores.py:672 swa_bd), run through
// fused_pallas.py:190-212 fwd_call.
//
// Per window of 16 tokens (the whole 4x4 sample of hqavit_c100, or one of
// the four 4x4 windows of hqavit_tiny_in's 8x8 grid, gathered from the
// sample's rows and scattered back, fused_ref.window_partition):
// xn = LN(x); qkv = xn @ W[192, 576]; Linformer E_k/E_v take the 16
// window tokens to 32 rows; the 16 raw bank rows are appended (kv = 48);
// 4-head softmax attention; proj 192 -> 192.  Each (sample, window) is a
// block in eval, so the shared memory per block is the same at n = 64.
// In training (one window per sample) the attention-probability and proj
// dropout masks come from the counter hash (common.cuh), and the branch
// LN feeds the bank-write partial sums, kept per block and summed over
// the blocks by the reduction pass.
//
// Bound on the H100 at B=1024 (bf16): it reads 6.3 MB and writes 12.6 MB
// (~5.6 us at 3.35 TB/s) and does ~5.9 GFLOP (~6 us at 989 TFLOP/s), so
// the card could finish it in ~6 us; neither bytes nor FLOPs dominate.
// This first design is latency-bound instead: 256 threads hold one
// sample at a time with ~148 KB of shared memory (one block per SM),
// float32 FMAs on the CUDA cores.  It keeps every intermediate out of
// device memory, which is what the bound rewards; tensor cores (wgmma)
// and several samples per block are later work.
//
// n = 64 (hqavit_tiny_in / hqavit_proc_tin, eval): float32 runs
// swa_kernel, one block per (sample, window).  bf16 runs swa_mma_kernel.
// Bound on the H100 at B=1024: 76 MB of x, out, xn and the float32
// weights (~23 us at 3.35 TB/s) against 23.4 GFLOP (~24 us at 989
// TFLOP/s), most of them the kv, q and proj products: the operations
// bound it, so every product runs on the tensor cores (mma.sync
// m16n8k16, bf16 operands, float32 sums; mma.cuh, mma_ops.cuh).  One
// block per SM walks the tiles of 64 rows, every value the plain version
// rounds to bf16 held as bf16 in shared memory (194 KB); the body and
// its layout are window_mma.cuh's.  A tile is a sample's four windows
// (swa_mma_kernel<1, false>), or at n = 16 (hqavit_c100, bf16) four
// samples of one window each, in eval (<4, false>) and in training (<4,
// true>: the dropout masks and the bank-write partials); float32, and
// bf16 at widths the tensor-core kernel is not written for, run
// swa_kernel at n = 16.  The weights reach the kernel as bf16 (the
// wrapper's cast is the kernel's own rounding of them).  n = 64 in
// training is swa_train64_kernel's (unit_swa_train64.cu).  Times at
// B=1024 on an NVIDIA H100 80GB HBM3, 700.00 W: PERF.md section 6 rows 1,
// 1 @n64.
#include "unit_swa.cuh"
#include "window_mma.cuh"

namespace qv {

__host__ __device__ inline int swa_smem_floats(const Dims& d) {
  const int c = d.c;
  return NT * c           // x, then the attention output, then LN(out)
         + NT * c         // xn, then the partials' compressed rows
         + NT * 3 * c     // qkv, then the proj output
         + 2 * d.lin_k * c  // compressed k, v
         + 2 * d.bank_s * c // bank k, v
         + pad4(d.heads * NT * (d.lin_k + d.bank_s))  // scores, gates
         + 2 * NT;        // LN stats
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS, 1) swa_kernel(SwaArgs a) {
  QV_SMEM_DECL
  __shared__ int bad;
  const Dims& d = a.d;
  const int c = d.c, lk = d.lin_k, S = d.bank_s;
  float* x = qv_smem;
  float* xn = x + NT * c;
  float* qkv = xn + NT * c;
  float* kc = qkv + NT * 3 * c;
  float* vc = kc + lk * c;
  float* bk = vc + lk * c;
  float* bv = bk + S * c;
  float* sc = bv + S * c;
  float* stats = sc + pad4(d.heads * NT * (lk + S));
  const SwaBufs s{x, xn, qkv, kc, vc, bk, bv, sc, sc, x, qkv, stats};
  float* part = d.train ? a.bw.part + (size_t)blockIdx.x * 2 * S * c : nullptr;

  if (threadIdx.x == 0) bad = 0;
  load_rounded<T>(bk, a.bank_k, S * c);
  load_rounded<T>(bv, a.bank_v, S * c);
  if (part != nullptr) fill(part, 2 * S * c, 0.f);
  __syncthreads();
  // window bw = b * nw + w; the bank partials (training) need the whole
  // sample in one window (the wrapper refuses training otherwise)
  auto window = [&](int bw, bool zero_attn, float* acc) {
    swa_body<T>(a, bw, zero_attn, s, &bad);
    const int b = bw / d.nw, w = bw - b * d.nw;
    const size_t off = (size_t)b * d.n * c;
    store_window<T>(static_cast<T*>(a.xn) + off, xn, d, w, c);
    store_window<T>(static_cast<T*>(a.out) + off, qkv, d, w, c);
    __syncthreads();
    if (acc != nullptr)
      bank_partials<T>(qkv, a.bw, c, S, x, xn, sc, stats, acc);
  };
  const int windows = d.B * d.nw;
  for (int bw = blockIdx.x; bw < windows; bw += gridDim.x)
    window(bw, false, part);
  if (d.guard)
    finish_guard(a.ws, bad, [&] {
      if (part != nullptr) {   // every block's partials restart here
        fill(a.bw.part, d.grid * 2 * S * c, 0.f);
        __syncthreads();
      }
      for (int bw = 0; bw < windows; ++bw) window(bw, true, part);
    });
}

// --- bf16: the tensor-core kernel (window_mma.cuh) ------------------------

// NS samples a tile: 1 at n = 64, 4 at n = 16; TRAIN the training
// instances
template <int NS, bool TRAIN>
__global__ void __launch_bounds__(NTHREADS, 1) swa_mma_kernel(SwaMmaArgs m) {
  window_mma<WIN_SWA, NS, TRAIN>(m);
}

}  // namespace qv

extern "C" int qv_unit_swa(const qv::SwaArgs* a, int is_bf16, void* stream) {
  // several windows: eval only, bf16 is qv_unit_swa_mma's
  if (a->d.nw != 1 && (a->d.train || is_bf16)) return qv::ERR_ARGS;
  const size_t smem = qv::swa_smem_floats(a->d) * sizeof(float);
  const int rc = is_bf16
                     ? qv_launch(qv::swa_kernel<qv::bf16>, *a, smem, stream,
                                     a->d.grid)
                     : qv_launch(qv::swa_kernel<float>, *a, smem, stream,
                                     a->d.grid);
  if (rc != 0 || !a->d.train) return rc;
  return qv_reduce(a->bw.part, a->bw.part_out, a->d.grid,
                   2 * a->d.bank_s * a->d.c, a->d.rgrid, stream);
}

extern "C" int qv_unit_swa_smem(const qv::Dims* d) {
  return qv::swa_smem_floats(*d) * (int)sizeof(float);
}

// The bf16 tensor-core kernel: `a` as for qv_unit_swa, the qkv and proj
// kernels rounded to bf16 beside it; one block per tile of 64 rows at
// most.  n = 64 in four windows on an 8x8 grid in eval, or n = 16 in one
// window in eval and training (then the reduction pass of the bank
// partials follows); ERR_ARGS for any other geometry or type (the wrapper
// checks them first, swa_mma_error).
extern "C" int qv_unit_swa_mma(const qv::SwaArgs* a, const void* qkv_w16,
                               const void* proj_w16, int is_bf16,
                               void* stream) {
  const qv::Dims& d = a->d;
  const bool n64 = d.n == qv::SM_N && d.nw == qv::SM_NW &&
                   d.side == qv::SM_SIDE && !d.train;
  const bool n16 = d.n == qv::NT && d.nw == 1 && d.side == qv::WS;
  const int tiles = (d.B * d.n + qv::SM_N - 1) / qv::SM_N;
  if (!is_bf16 || !(n64 || n16) || d.c != qv::SM_C || d.heads != qv::SM_H ||
      d.lin_k != qv::SM_LK || d.bank_s > qv::SM_S || d.grid > tiles)
    return qv::ERR_ARGS;
  const qv::SwaMmaArgs m{*a, static_cast<const qv::bf16*>(qkv_w16),
                         static_cast<const qv::bf16*>(proj_w16)};
  const size_t smem = qv::SM_SMEM_BYTES;
  const int rc =
      n64 ? qv_launch(qv::swa_mma_kernel<1, false>, m, smem, stream, d.grid)
      : d.train
          ? qv_launch(qv::swa_mma_kernel<4, true>, m, smem, stream, d.grid)
          : qv_launch(qv::swa_mma_kernel<4, false>, m, smem, stream, d.grid);
  if (rc != 0 || !d.train) return rc;
  return qv_reduce(a->bw.part, a->bw.part_out, d.grid, 2 * d.bank_s * d.c,
                   d.rgrid, stream);
}

extern "C" int qv_unit_swa_mma_smem(const qv::Dims*) {
  return qv::SM_SMEM_BYTES;
}

