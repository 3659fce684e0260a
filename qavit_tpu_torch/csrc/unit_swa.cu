// Unit 1 of the fused block, eval forward: norm1 LayerNorm + SWA branch.
//
// Replaces the TPU unit qavit_tpu/kernels/fused_kernels.py
// make_cores.core_swa (fused_cores.py:672 swa_bd), run through
// fused_pallas.py:190-212 fwd_call.
//
// Per sample: xn = LN(x); qkv = xn @ W[192, 576]; Linformer E_k/E_v take
// the 16 window tokens to 32 rows; the 16 raw bank rows are appended
// (kv = 48); 4-head softmax attention; proj 192 -> 192.  The branch LN
// that feeds the training-time bank write is not computed in eval.
//
// Bound on the H100 at B=1024 (bf16): it reads 6.3 MB and writes 12.6 MB
// (~5.6 us at 3.35 TB/s) and does ~5.9 GFLOP (~6 us at 989 TFLOP/s), so
// the card could finish it in ~6 us; neither bytes nor FLOPs dominate.
// This first design is latency-bound instead: one block of 256 threads per
// sample with ~148 KB of shared memory (one block per SM), float32 FMAs on
// the CUDA cores.  It keeps every intermediate out of device memory, which
// is what the bound rewards; tensor cores (wgmma) and several samples per
// block are later work.
#include "common.cuh"

namespace qv {

__host__ __device__ inline int swa_smem_floats(const Dims& d) {
  const int c = d.c, kv = d.lin_k + d.bank_s;
  return NT * c           // xs (x, then the attention output)
         + NT * c         // xn
         + NT * 3 * c     // qkv (then the proj output)
         + 2 * d.lin_k * c  // compressed k, v
         + 2 * d.bank_s * c // bank k, v
         + ((d.heads * NT * kv + 3) / 4) * 4  // scores
         + 2 * NT;        // LN stats
}

template <typename T>
__device__ void swa_sample(const SwaArgs& a, int b, bool zero_attn,
                           float* sm, int* bad) {
  const Dims& d = a.d;
  const int c = d.c, lk = d.lin_k, s = d.bank_s, h = d.heads;
  float* xs = sm;
  float* xn = xs + NT * c;
  float* qkv = xn + NT * c;
  float* kc = qkv + NT * 3 * c;
  float* vc = kc + lk * c;
  float* bk = vc + lk * c;
  float* bv = bk + s * c;
  float* sc = bv + s * c;
  float* stats = sc + ((h * NT * (lk + s) + 3) / 4) * 4;

  if (threadIdx.x == 0) *bad = 0;
  load_tile<T>(xs, static_cast<const T*>(a.x) + (size_t)b * NT * c, NT * c);
  load_rounded<T>(bk, a.bank_k, s * c);
  load_rounded<T>(bv, a.bank_v, s * c);
  __syncthreads();
  layer_norm_rows<T>(xs, c, xn, c, NT, c, a.norm1_s, a.norm1_b, stats);
  store_tile<T>(static_cast<T*>(a.xn) + (size_t)b * NT * c, xn, NT * c);
  dense_rows<T>(xn, c, 0, NT, c, a.qkv_w, 3 * c, a.qkv_b, 3 * c, 1, qkv,
                3 * c);
  __syncthreads();
  token_mix<T>(a.e_k, lk, NT, qkv + c, 3 * c, c, kc, c);
  token_mix<T>(a.e_v, lk, NT, qkv + 2 * c, 3 * c, c, vc, c);
  __syncthreads();
  if (zero_attn) {
    fill(xs, NT * c, 0.f);
    __syncthreads();
  } else {
    attention<T>(qkv, 3 * c, NT, h, c / h, kc, vc, c, lk, bk, bv, c, s, h,
                 xs, c, sc, bad, d.guard != 0);
  }
  dense_rows<T>(xs, c, 0, NT, c, a.proj_w, c, a.proj_b, c, 1, qkv, c);
  __syncthreads();
  store_tile<T>(static_cast<T*>(a.out) + (size_t)b * NT * c, qkv, NT * c);
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS) swa_kernel(SwaArgs a) {
  QV_SMEM_DECL
  __shared__ int bad;
  swa_sample<T>(a, blockIdx.x, false, qv_smem, &bad);
  if (a.d.guard)
    finish_guard(a.ws, bad,
                 [&](int b) { swa_sample<T>(a, b, true, qv_smem, &bad); });
}

}  // namespace qv

extern "C" int qv_unit_swa(const qv::SwaArgs* a, int is_bf16, void* stream) {
  const size_t smem = qv::swa_smem_floats(a->d) * sizeof(float);
  return is_bf16 ? qv_launch(qv::swa_kernel<qv::bf16>, *a, smem, stream)
                 : qv_launch(qv::swa_kernel<float>, *a, smem, stream);
}

extern "C" int qv_unit_swa_smem(const qv::Dims* d) {
  return qv::swa_smem_floats(*d) * (int)sizeof(float);
}
