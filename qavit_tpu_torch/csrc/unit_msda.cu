// Unit 2 of the fused block, eval forward: the MSDA branch.
//
// Replaces the TPU unit qavit_tpu/kernels/fused_kernels.py
// make_cores.core_msda (fused_cores.py:687 msda_bd), run through
// fused_pallas.py:190-212 fwd_call.
//
// Per sample: the dilated (1,2) gather and stride-2 landmark pooling are
// one constant [10, 16] mixing matrix; kv = pooled @ W[:, 192:576]; the
// Linformer E uses only its first msda_keep = 10 rows (the rest meet the
// zero padding); the 16 raw bank rows are appended (kv = 48);
// q = xn @ W[:, :192]; 4-head softmax attention; proj 192 -> 192.
//
// Bound on the H100 at B=1024 (bf16): 6.3 MB read + 6.3 MB written
// (~3.8 us) and ~3.5 GFLOP (~3.5 us): either limit allows a few
// microseconds.  The design is the SWA unit's: one 256-thread block per
// sample, all intermediates in ~160 KB of shared memory, float32 FMAs;
// it is latency-bound, and tensor cores are later work.
#include "common.cuh"

namespace qv {

__host__ __device__ inline int msda_smem_floats(const Dims& d) {
  const int c = d.c, kv = d.lin_k + d.bank_s;
  return NT * c             // xs
         + NT * c           // pooled (then the proj output)
         + NT * 2 * c       // kv of the pooled rows
         + 2 * d.lin_k * c  // compressed k, v
         + 2 * d.bank_s * c // bank k, v
         + NT * c           // q
         + NT * c           // attention output
         + ((d.heads * NT * kv + 3) / 4) * 4;
}

template <typename T>
__device__ void msda_sample(const MsdaArgs& a, int b, bool zero_attn,
                            float* sm, int* bad) {
  const Dims& d = a.d;
  const int c = d.c, lk = d.lin_k, s = d.bank_s, h = d.heads;
  const int keep = d.msda_keep;
  float* xs = sm;
  float* pooled = xs + NT * c;
  float* kv = pooled + NT * c;
  float* kc = kv + NT * 2 * c;
  float* vc = kc + lk * c;
  float* bk = vc + lk * c;
  float* bv = bk + s * c;
  float* q = bv + s * c;
  float* att = q + NT * c;
  float* sc = att + NT * c;

  if (threadIdx.x == 0) *bad = 0;
  load_tile<T>(xs, static_cast<const T*>(a.xn) + (size_t)b * NT * c, NT * c);
  load_rounded<T>(bk, a.bank_k, s * c);
  load_rounded<T>(bv, a.bank_v, s * c);
  __syncthreads();
  token_mix<T>(a.sel_t, keep, NT, xs, c, c, pooled, c);
  __syncthreads();
  dense_rows<T>(pooled, c, 0, keep, c, a.qkv_w + c, 3 * c, a.qkv_b + c,
                2 * c, 1, kv, 2 * c);
  dense_rows<T>(xs, c, 0, NT, c, a.qkv_w, 3 * c, a.qkv_b, c, 1, q, c);
  __syncthreads();
  token_mix<T>(a.e_k, lk, keep, kv, 2 * c, c, kc, c);
  token_mix<T>(a.e_v, lk, keep, kv + c, 2 * c, c, vc, c);
  __syncthreads();
  if (zero_attn) {
    fill(att, NT * c, 0.f);
    __syncthreads();
  } else {
    attention<T>(q, c, NT, h, c / h, kc, vc, c, lk, bk, bv, c, s, h, att, c,
                 sc, bad, d.guard != 0);
  }
  dense_rows<T>(att, c, 0, NT, c, a.proj_w, c, a.proj_b, c, 1, pooled, c);
  __syncthreads();
  store_tile<T>(static_cast<T*>(a.out) + (size_t)b * NT * c, pooled, NT * c);
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS) msda_kernel(MsdaArgs a) {
  QV_SMEM_DECL
  __shared__ int bad;
  msda_sample<T>(a, blockIdx.x, false, qv_smem, &bad);
  if (a.d.guard)
    finish_guard(a.ws, bad,
                 [&](int b) { msda_sample<T>(a, b, true, qv_smem, &bad); });
}

}  // namespace qv

extern "C" int qv_unit_msda(const qv::MsdaArgs* a, int is_bf16,
                            void* stream) {
  const size_t smem = qv::msda_smem_floats(a->d) * sizeof(float);
  return is_bf16 ? qv_launch(qv::msda_kernel<qv::bf16>, *a, smem, stream)
                 : qv_launch(qv::msda_kernel<float>, *a, smem, stream);
}

extern "C" int qv_unit_msda_smem(const qv::Dims* d) {
  return qv::msda_smem_floats(*d) * (int)sizeof(float);
}
