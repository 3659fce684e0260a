// Unit 4 of the fused block, forward (eval and train): cross branch +
// block tail.
//
// Replaces the TPU unit qavit_tpu/kernels/fused_kernels.py
// make_cores.core_cross_tail (fused_cores.py:699 cross_bd, :779 tail_bd),
// run through fused_pallas.py:190-212 fwd_call.
//
// Per sample: cross-attention of the 16 tokens onto the bank (q = Dense
// 192 -> 192 on xn, bank K/V = Dense 192 -> 192 on the 16 slots,
// computed once per block as in the TPU body), proj; then the tail:
// 4 x (LN + compress 192 -> 48), softmax fusion weights, bottleneck
// 192 -> 96 GELU -> 192, residual; norm2, CCF-FFN fc1 192 -> 96, GELU,
// LN, 3x3 depthwise correlation on the 4x4 grid with a zero halo
// (bias before the 0.1 scale), LN, fc2 96 -> 192, x gamma; residual.
// In training: the hash dropout masks and the per-sample drop-path
// factors of both residuals.
//
// Bound on the H100 at B=1024 (bf16): five [B,16,192] inputs read and one
// written, 37.7 MB (~11 us at 3.35 TB/s), against ~8.5 GFLOP (~9 us): the
// bytes bound it.  A 256-thread block holds one sample at a time and
// reads each input once into shared memory (~139 KB, float32, above the
// 48 KB static limit, so the launch opts in to dynamic shared memory) and
// writes only y; no intermediate of the tail touches device memory.  It
// runs on the CUDA cores in float32 and is latency-bound for now.
//
// n = 64 (hqavit_tiny_in, eval): everything but the dwconv works row by
// row, so cross_tail_tiled_kernel runs a sample as two passes over
// 16-token tiles with the per-tile buffers of the n = 16 kernel: the
// first up to the dwconv's input, kept for the whole sample (64 x 96
// floats) beside x + bottleneck (64 x 192, the residual the second pass
// adds to); the second the dwconv over the 8x8 grid (its halo rows come
// from the neighbouring tiles), post-norm, fc2 and the residual.  188 KB
// of shared memory at C=192; the bank rows share the residual's space
// during the per-block prologue.
#include "unit_cross_tail.cuh"

namespace qv {

__host__ __device__ inline int cross_tail_smem_floats(const Dims& d) {
  const int c = d.c, s = d.bank_s;
  const int hid = d.ccf_hidden > d.bottleneck_hidden ? d.ccf_hidden
                                                     : d.bottleneck_hidden;
  return 6 * NT * c          // xn/branch, q/fused, att/x1, cross, fin, y
         + 4 * s * c         // bank rows k, v; projected bank k, v
         + NT * hid          // hidden activations
         + NT * hid          // dwconv output
         + pad4(d.heads * NT * s)
         + 2 * NT;           // LN stats
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS, 1)
    cross_tail_kernel(CrossTailArgs a) {
  QV_SMEM_DECL
  __shared__ int bad;
  const Dims& d = a.d;
  const int c = d.c, S = d.bank_s;
  const int hmax = d.ccf_hidden > d.bottleneck_hidden ? d.ccf_hidden
                                                      : d.bottleneck_hidden;
  float* A = qv_smem;          // xn, then each branch's LN
  float* Q = A + NT * c;       // cross q, then the fused concat
  float* R = Q + NT * c;       // attention output, then x + bottleneck
  float* X = R + NT * c;       // cross branch output
  float* Y = X + NT * c;       // bottleneck output, then norm2
  float* Z = Y + NT * c;       // fc2 output, then the block output
  float* bk = Z + NT * c;
  float* bv = bk + S * c;
  float* kb = bv + S * c;
  float* vb = kb + S * c;
  float* H1 = vb + S * c;
  float* H2 = H1 + NT * hmax;
  float* sc = H2 + NT * hmax;
  float* stats = sc + pad4(d.heads * NT * S);
  const CrossTailBufs s{A,  Q,  kb, vb, R,  X,  sc, sc, A,  Q,  Q,  H1, H1,
                        Y,  R,  Y,  H1, H1, H1, H2, H2, H2, Z,  Z,  stats};

  if (threadIdx.x == 0) bad = 0;
  load_rounded<T>(bk, a.bank_k, S * c);
  load_rounded<T>(bv, a.bank_v, S * c);
  __syncthreads();
  cross_tail_prologue<T>(a, bk, bv, s);
  auto sample = [&](int b, bool zero_attn) {
    cross_tail_body<T>(a, b, zero_attn, s, &bad);
    store_tile<T>(static_cast<T*>(a.y) + (size_t)b * NT * c, Z, NT * c);
    __syncthreads();
  };
  for (int b = blockIdx.x; b < d.B; b += gridDim.x) sample(b, false);
  if (d.guard)
    finish_guard(a.ws, bad, [&] {
      for (int b = 0; b < d.B; ++b) sample(b, true);
    });
}

__host__ __device__ inline int cross_tail_tiled_smem_floats(const Dims& d) {
  const int c = d.c, s = d.bank_s;
  const int hmax = d.ccf_hidden > d.bottleneck_hidden ? d.ccf_hidden
                                                      : d.bottleneck_hidden;
  const int x1 = d.n * c > 2 * s * c ? d.n * c : 2 * s * c;
  return 6 * NT * c          // xn/branch, q/fused, att, cross, fin, y
         + 2 * s * c         // projected bank k, v
         + 2 * NT * hmax     // bottleneck hidden; dwconv output
         + pad4(d.heads * NT * s)
         + 2 * NT            // LN stats
         + x1                // x + bottleneck, all rows; bank rows k, v
         + d.n * d.ccf_hidden;  // the dwconv's input, all rows
}

// Eval only, n a multiple of NT; one block per sample.
template <typename T>
__global__ void __launch_bounds__(NTHREADS, 1)
    cross_tail_tiled_kernel(CrossTailArgs a) {
  QV_SMEM_DECL
  __shared__ int bad;
  const Dims& d = a.d;
  const int c = d.c, S = d.bank_s, n = d.n, hc = d.ccf_hidden;
  const int hmax = d.ccf_hidden > d.bottleneck_hidden ? d.ccf_hidden
                                                      : d.bottleneck_hidden;
  float* A = qv_smem;          // xn, then each branch's LN
  float* Q = A + NT * c;       // cross q, then the fused concat
  float* R = Q + NT * c;       // attention output
  float* X = R + NT * c;       // cross branch output
  float* Y = X + NT * c;       // bottleneck output, then norm2
  float* Z = Y + NT * c;       // fc2 output, then the block output
  float* kb = Z + NT * c;
  float* vb = kb + S * c;
  float* H1 = vb + S * c;      // bottleneck hidden
  float* H2 = H1 + NT * hmax;  // dwconv output
  float* sc = H2 + NT * hmax;
  float* stats = sc + pad4(d.heads * NT * S);
  float* X1 = stats + 2 * NT;  // [n, c] x + bottleneck
  float* HD = X1 + (n * c > 2 * S * c ? n * c : 2 * S * c);  // [n, hc]

  if (threadIdx.x == 0) bad = 0;
  load_rounded<T>(X1, a.bank_k, S * c);
  load_rounded<T>(X1 + S * c, a.bank_v, S * c);
  __syncthreads();
  {
    CrossTailBufs p{};
    p.kb = kb;
    p.vb = vb;
    cross_tail_prologue<T>(a, X1, X1 + S * c, p);
  }
  // the buffers of rows [t0, t0 + NT)
  auto tile = [&](int t0) {
    return CrossTailBufs{A,  Q,  kb, vb, R,  X,  sc, sc, A,
                         Q,  Q,  H1, H1, Y,  X1 + t0 * c, Y,
                         HD + t0 * hc, HD + t0 * hc, HD + t0 * hc,
                         H2, H2, H2, Z,  Z,  stats};
  };
  auto sample = [&](int b, bool zero_attn) {
    for (int t0 = 0; t0 < n; t0 += NT)   // the dwconv's input lands in HD
      cross_tail_front<T>(a, b, t0, zero_attn, tile(t0), &bad);
    for (int t0 = 0; t0 < n; t0 += NT) {
      const CrossTailBufs s = tile(t0);
      ccf_dwconv<T>(a, HD, t0, s);
      cross_tail_back<T>(a, b, t0, s);
      store_tile<T>(static_cast<T*>(a.y) + ((size_t)b * n + t0) * c, Z,
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

extern "C" int qv_unit_cross_tail_smem(const qv::Dims* d);

extern "C" int qv_unit_cross_tail(const qv::CrossTailArgs* a, int is_bf16,
                                  void* stream) {
  const size_t smem = qv_unit_cross_tail_smem(&a->d);
  if (a->d.n != qv::NT) {         // eval only
    if (a->d.train) return qv::ERR_ARGS;
    return is_bf16 ? qv_launch(qv::cross_tail_tiled_kernel<qv::bf16>, *a,
                               smem, stream, a->d.grid)
                   : qv_launch(qv::cross_tail_tiled_kernel<float>, *a, smem,
                               stream, a->d.grid);
  }
  return is_bf16 ? qv_launch(qv::cross_tail_kernel<qv::bf16>, *a, smem, stream,
                             a->d.grid)
                 : qv_launch(qv::cross_tail_kernel<float>, *a, smem, stream,
                             a->d.grid);
}

extern "C" int qv_unit_cross_tail_smem(const qv::Dims* d) {
  return (d->n == qv::NT ? qv::cross_tail_smem_floats(*d)
                         : qv::cross_tail_tiled_smem_floats(*d)) *
         (int)sizeof(float);
}

// sizeof of each argument struct, for the loader's layout check (one
// definition for the whole library)
extern "C" int qv_struct_size(int which) {
  switch (which) {
    case 0: return (int)sizeof(qv::Dims);
    case 1: return (int)sizeof(qv::SwaArgs);
    case 2: return (int)sizeof(qv::MsdaArgs);
    case 3: return (int)sizeof(qv::CgaArgs);
    case 4: return (int)sizeof(qv::CrossTailArgs);
    case 5: return (int)sizeof(qv::SwaBwdArgs);
    case 6: return (int)sizeof(qv::MsdaBwdArgs);
    case 7: return (int)sizeof(qv::CgaBwdArgs);
    case 8: return (int)sizeof(qv::CrossTailBwdArgs);
  }
  return -1;
}
