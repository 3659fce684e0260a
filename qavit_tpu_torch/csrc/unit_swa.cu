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
#include "unit_swa.cuh"

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

}  // namespace qv

extern "C" int qv_unit_swa(const qv::SwaArgs* a, int is_bf16, void* stream) {
  if (a->d.train && a->d.nw != 1) return qv::ERR_ARGS;
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
