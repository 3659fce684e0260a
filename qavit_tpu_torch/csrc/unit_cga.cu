// Unit 3 of the fused block, eval forward: the CGA branch.
//
// Replaces the TPU unit qavit_tpu/kernels/fused_kernels.py
// make_cores.core_cga (fused_cores.py:708 cga_bd, _cga_sweep :295), run
// through fused_pallas.py:190-212 fwd_call.
//
// Per sample: 6 channel groups of 32; q/k/v = Dense 32 -> 16 per group
// (weights shared by the groups); the bank K/V projected 192 -> 16 once
// and shared by the groups (kv = 16 + 16 = 32); 24 virtual heads
// (6 groups x 4 heads) of width 4, float32 softmax; proj 96 -> 192.  The
// bank projections are the kernel's own work, as in the TPU body; each
// block recomputes them (2 x 16 x 192 x 16 MACs, ~2% of the unit).
//
// Bound on the H100 at B=1024 (bf16): 6.3 MB read + 6.3 MB written
// (~3.8 us) against ~0.9 GFLOP (~1 us): the bytes bound it.  One
// 256-thread block per sample keeps the [24, 16, 32] float32 scores and
// every projection in ~100 KB of shared memory, so the unit moves only its
// input and output through device memory; it is latency-bound for now.
#include "common.cuh"

namespace qv {

__host__ __device__ inline int cga_smem_floats(const Dims& d) {
  const int c = d.c, gw = d.groups * d.cperg, s = d.bank_s;
  return NT * c                 // xs (then the proj output)
         + 3 * NT * gw          // q, k, v of all groups
         + s * c                // bank rows
         + 2 * s * d.cperg      // projected bank k, v
         + NT * gw              // attention output
         + ((d.groups * d.heads * NT * (NT + s) + 3) / 4) * 4;
}

template <typename T>
__device__ void cga_sample(const CgaArgs& a, int b, bool zero_attn,
                           float* sm, int* bad) {
  const Dims& d = a.d;
  const int c = d.c, s = d.bank_s, gg = d.groups, cperg = d.cperg;
  const int gw = gg * cperg, cpg = c / gg;
  float* xs = sm;
  float* q = xs + NT * c;
  float* k = q + NT * gw;
  float* v = k + NT * gw;
  float* braw = v + NT * gw;
  float* kbp = braw + s * c;
  float* vbp = kbp + s * cperg;
  float* att = vbp + s * cperg;
  float* sc = att + NT * gw;

  if (threadIdx.x == 0) *bad = 0;
  load_tile<T>(xs, static_cast<const T*>(a.xn) + (size_t)b * NT * c, NT * c);
  load_rounded<T>(braw, a.bank_k, s * c);
  __syncthreads();
  dense_rows<T>(xs, c, cpg, NT, cpg, a.q_w, cperg, a.q_b, cperg, gg, q, gw);
  dense_rows<T>(xs, c, cpg, NT, cpg, a.k_w, cperg, a.k_b, cperg, gg, k, gw);
  dense_rows<T>(xs, c, cpg, NT, cpg, a.v_w, cperg, a.v_b, cperg, gg, v, gw);
  dense_rows<T>(braw, c, 0, s, c, a.bk_w, cperg, a.bk_b, cperg, 1, kbp,
                cperg);
  __syncthreads();
  load_rounded<T>(braw, a.bank_v, s * c);
  __syncthreads();
  dense_rows<T>(braw, c, 0, s, c, a.bv_w, cperg, a.bv_b, cperg, 1, vbp,
                cperg);
  __syncthreads();
  if (zero_attn) {
    fill(att, NT * gw, 0.f);
    __syncthreads();
  } else {
    attention<T>(q, gw, NT, gg * d.heads, cperg / d.heads, k, v, gw, NT, kbp,
                 vbp, cperg, s, d.heads, att, gw, sc, bad, d.guard != 0);
  }
  dense_rows<T>(att, gw, 0, NT, gw, a.proj_w, c, a.proj_b, c, 1, xs, c);
  __syncthreads();
  store_tile<T>(static_cast<T*>(a.out) + (size_t)b * NT * c, xs, NT * c);
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS) cga_kernel(CgaArgs a) {
  QV_SMEM_DECL
  __shared__ int bad;
  cga_sample<T>(a, blockIdx.x, false, qv_smem, &bad);
  if (a.d.guard)
    finish_guard(a.ws, bad,
                 [&](int b) { cga_sample<T>(a, b, true, qv_smem, &bad); });
}

}  // namespace qv

extern "C" int qv_unit_cga(const qv::CgaArgs* a, int is_bf16, void* stream) {
  const size_t smem = qv::cga_smem_floats(a->d) * sizeof(float);
  return is_bf16 ? qv_launch(qv::cga_kernel<qv::bf16>, *a, smem, stream)
                 : qv_launch(qv::cga_kernel<float>, *a, smem, stream);
}

extern "C" int qv_unit_cga_smem(const qv::Dims* d) {
  return qv::cga_smem_floats(*d) * (int)sizeof(float);
}
