// Unit 2 of the fused block, forward (eval and train): the MSDA branch.
//
// Replaces the TPU unit qavit_tpu/kernels/fused_kernels.py
// make_cores.core_msda (fused_cores.py:687 msda_bd), run through
// fused_pallas.py:190-212 fwd_call.
//
// Per sample: the dilated (1,2) gather and stride-2 landmark pooling are
// one constant [10, 16] mixing matrix; kv = pooled @ W[:, 192:576]; the
// Linformer E uses only its first msda_keep = 10 rows (the rest meet the
// zero padding); the 16 raw bank rows are appended (kv = 48);
// q = xn @ W[:, :192]; 4-head softmax attention; proj 192 -> 192.  In
// training: the hash masks and the bank-write partials, as in unit 1.
//
// Bound on the H100 at B=1024 (bf16): 6.3 MB read + 6.3 MB written
// (~3.8 us) and ~3.5 GFLOP (~3.5 us): either limit allows a few
// microseconds.  The design is the SWA unit's: 256 threads hold one
// sample at a time, all intermediates in ~160 KB of shared memory,
// float32 FMAs; it is latency-bound, and tensor cores are later work.
//
// n = 64 (hqavit_tiny_in, eval): the sample's 64 xn rows (48 KB), its 40
// pooled rows and their kv (90 KB) do not fit beside all 64 queries'
// scores, so msda_tiled_kernel keeps xn, the compressed K/V (32 + 16
// rows per head) and the bank in shared memory, builds the pooled rows
// and kv once per sample (in 16-row tiles), and then runs q, scores, PV
// and proj over 16-query tiles in the space the pooled rows held (215 KB
// at C=192).  Every element is summed in the order of the n = 16 kernel.
#include "unit_msda.cuh"

namespace qv {

__host__ __device__ inline int msda_smem_floats(const Dims& d) {
  const int c = d.c;
  return NT * c             // xs
         + NT * c           // pooled, then the proj output
         + NT * 2 * c       // kv of the pooled rows
         + 2 * d.lin_k * c  // compressed k, v
         + 2 * d.bank_s * c // bank k, v
         + NT * c           // q, then the partials' compressed rows
         + NT * c           // attention output, then LN(out)
         + pad4(d.heads * NT * (d.lin_k + d.bank_s))
         + 2 * NT;          // LN stats
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS, 1) msda_kernel(MsdaArgs a) {
  QV_SMEM_DECL
  __shared__ int bad;
  const Dims& d = a.d;
  const int c = d.c, lk = d.lin_k, S = d.bank_s;
  float* xs = qv_smem;
  float* pooled = xs + NT * c;
  float* kv = pooled + NT * c;
  float* kc = kv + NT * 2 * c;
  float* vc = kc + lk * c;
  float* bk = vc + lk * c;
  float* bv = bk + S * c;
  float* q = bv + S * c;
  float* att = q + NT * c;
  float* sc = att + NT * c;
  float* stats = sc + pad4(d.heads * NT * (lk + S));
  const MsdaBufs s{xs, pooled, kv, kc, vc, bk, bv, q, att, pooled, sc, sc};
  float* part = d.train ? a.bw.part + (size_t)blockIdx.x * 2 * S * c : nullptr;

  if (threadIdx.x == 0) bad = 0;
  load_rounded<T>(bk, a.bank_k, S * c);
  load_rounded<T>(bv, a.bank_v, S * c);
  if (part != nullptr) fill(part, 2 * S * c, 0.f);
  __syncthreads();
  auto sample = [&](int b, bool zero_attn, float* acc) {
    msda_body<T>(a, b, zero_attn, s, &bad);
    store_tile<T>(static_cast<T*>(a.out) + (size_t)b * NT * c, pooled,
                  NT * c);
    __syncthreads();
    if (acc != nullptr)
      bank_partials<T>(pooled, a.bw, c, S, att, q, sc, stats, acc);
  };
  for (int b = blockIdx.x; b < d.B; b += gridDim.x) sample(b, false, part);
  if (d.guard)
    finish_guard(a.ws, bad, [&] {
      if (part != nullptr) {
        fill(a.bw.part, d.grid * 2 * S * c, 0.f);
        __syncthreads();
      }
      for (int b = 0; b < d.B; ++b) sample(b, true, part);
    });
}

__host__ __device__ inline int msda_tiled_smem_floats(const Dims& d) {
  const int c = d.c, kv = d.lin_k + d.bank_s;
  const int pool = 3 * d.msda_keep * c;                 // pooled, its k|v
  const int tile = 2 * NT * c + pad4(d.heads * NT * kv);  // q / o, att, sc
  return d.n * c              // xn
         + 2 * d.lin_k * c    // compressed k, v
         + 2 * d.bank_s * c   // bank k, v
         + (pool > tile ? pool : tile);
}

// Eval only, n a multiple of NT; one block per sample.
template <typename T>
__global__ void __launch_bounds__(NTHREADS, 1)
    msda_tiled_kernel(MsdaArgs a) {
  QV_SMEM_DECL
  __shared__ int bad;
  const Dims& d = a.d;
  const int c = d.c, lk = d.lin_k, S = d.bank_s, h = d.heads;
  const int n = d.n, keep = d.msda_keep;
  float* xs = qv_smem;
  float* kc = xs + n * c;
  float* vc = kc + lk * c;
  float* bk = vc + lk * c;
  float* bv = bk + S * c;
  float* pooled = bv + S * c;     // [keep, c], then the query tiles:
  float* kvp = pooled + keep * c;  // [keep, 2c]
  float* q = pooled;              // [NT, c] q, then the proj output
  float* att = q + NT * c;        // [NT, c]
  float* sc = att + NT * c;       // [heads, NT, lin_k + S]

  if (threadIdx.x == 0) bad = 0;
  load_rounded<T>(bk, a.bank_k, S * c);
  load_rounded<T>(bv, a.bank_v, S * c);
  __syncthreads();
  auto sample = [&](int b, bool zero_attn) {
    const size_t off = (size_t)b * n * c;
    load_tile<T>(xs, static_cast<const T*>(a.xn) + off, n * c);
    __syncthreads();
    token_mix<T>(a.sel_t, keep, n, xs, c, c, pooled, c);
    __syncthreads();
    for (int r0 = 0; r0 < keep; r0 += NT)
      dense_rows<T>(pooled + r0 * c, c, 0, keep - r0 < NT ? keep - r0 : NT, c,
                    a.qkv_w + c, 3 * c, a.qkv_b + c, 2 * c, 1,
                    kvp + r0 * 2 * c, 2 * c);
    __syncthreads();
    token_mix<T>(a.e_k, lk, keep, kvp, 2 * c, c, kc, c);
    token_mix<T>(a.e_v, lk, keep, kvp + c, 2 * c, c, vc, c);
    __syncthreads();
    for (int t0 = 0; t0 < n; t0 += NT) {
      dense_rows<T>(xs + t0 * c, c, 0, NT, c, a.qkv_w, 3 * c, a.qkv_b, c, 1,
                    q, c);
      __syncthreads();
      if (zero_attn) {
        fill(att, NT * c, 0.f);
        __syncthreads();
      } else {
        attention<T>(q, c, NT, h, c / h, kc, vc, c, lk, bk, bv, c, S, h, att,
                     c, sc, sc, no_drop(), 0u, &bad, d.guard != 0);
      }
      dense_rows<T>(att, c, 0, NT, c, a.proj_w, c, a.proj_b, c, 1, q, c);
      __syncthreads();
      store_tile<T>(static_cast<T*>(a.out) + off + (size_t)t0 * c, q,
                    NT * c);
      __syncthreads();
    }
  };
  for (int b = blockIdx.x; b < d.B; b += gridDim.x) sample(b, false);
  if (d.guard)
    finish_guard(a.ws, bad, [&] {
      for (int b = 0; b < d.B; ++b) sample(b, true);
    });
}

}  // namespace qv

extern "C" int qv_unit_msda_smem(const qv::Dims* d);

extern "C" int qv_unit_msda(const qv::MsdaArgs* a, int is_bf16,
                            void* stream) {
  const size_t smem = qv_unit_msda_smem(&a->d);
  if (a->d.n != qv::NT) {         // eval only
    if (a->d.train) return qv::ERR_ARGS;
    return is_bf16 ? qv_launch(qv::msda_tiled_kernel<qv::bf16>, *a, smem,
                               stream, a->d.grid)
                   : qv_launch(qv::msda_tiled_kernel<float>, *a, smem,
                               stream, a->d.grid);
  }
  const int rc =
      is_bf16 ? qv_launch(qv::msda_kernel<qv::bf16>, *a, smem, stream,
                          a->d.grid)
              : qv_launch(qv::msda_kernel<float>, *a, smem, stream, a->d.grid);
  if (rc != 0 || !a->d.train) return rc;
  return qv_reduce(a->bw.part, a->bw.part_out, a->d.grid,
                   2 * a->d.bank_s * a->d.c, a->d.rgrid, stream);
}

extern "C" int qv_unit_msda_smem(const qv::Dims* d) {
  return (d->n == qv::NT ? qv::msda_smem_floats(*d)
                         : qv::msda_tiled_smem_floats(*d)) *
         (int)sizeof(float);
}
