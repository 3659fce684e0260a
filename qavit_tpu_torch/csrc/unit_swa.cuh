// The per-window body of unit 1 (norm1 LayerNorm + SWA branch), shared by
// the forward kernel (unit_swa.cu) and the backward kernel
// (unit_swa_bwd.cu), which recomputes the sample through this same code
// and so sees the forward's values bit for bit.  A window is NT tokens of
// one sample; with one window per sample (n = NT) it is the sample.
#pragma once
#include "common.cuh"

namespace qv {

// Where the body keeps each value; buffers may alias where the caller no
// longer needs a value (the forward kernel aliases, the backward does not).
struct SwaBufs {
  float* x;      // [NT, c] the input
  float* xn;     // [NT, c] norm1(x)
  float* qkv;    // [NT, 3c]
  float* kc;     // [lin_k, c] Linformer-compressed k
  float* vc;     // [lin_k, c]
  const float* bk;  // [S, c] bank rows rounded to the working type
  const float* bv;
  float* sc;     // [heads, NT, lin_k + S] probabilities
  float* pr;     // the probabilities used for PV (may equal sc)
  float* att;    // [NT, c] attention output
  float* o;      // [NT, c] proj output after dropout = the unit's `out`
  float* stats;  // 2*NT
};

// Window bw = b * nw + w (window w of sample b), the index of the JAX
// package's [B * nw, ws2, ...] window layout, which its masks follow.
template <typename T>
__device__ void swa_body(const SwaArgs& a, int bw, bool zero_attn,
                         const SwaBufs& s, int* bad) {
  const Dims& d = a.d;
  const int c = d.c, lk = d.lin_k, S = d.bank_s, h = d.heads;
  const int b = bw / d.nw;
  load_window<T>(s.x, static_cast<const T*>(a.x) + (size_t)b * d.n * c, d,
                 bw - b * d.nw, c);
  __syncthreads();
  layer_norm_rows<T>(s.x, c, s.xn, c, NT, c, a.norm1_s, a.norm1_b, s.stats);
  dense_rows<T>(s.xn, c, 0, NT, c, a.qkv_w, 3 * c, a.qkv_b, 3 * c, 1, s.qkv,
                3 * c);
  __syncthreads();
  token_mix<T>(a.e_k, lk, NT, s.qkv + c, 3 * c, c, s.kc, c);
  token_mix<T>(a.e_v, lk, NT, s.qkv + 2 * c, 3 * c, c, s.vc, c);
  __syncthreads();
  if (zero_attn) {
    fill(s.att, NT * c, 0.f);
    __syncthreads();
  } else {
    attention<T>(s.qkv, 3 * c, NT, h, c / h, s.kc, s.vc, c, lk, s.bk, s.bv,
                 c, S, h, s.att, c, s.sc, s.pr, attn_drop(d, SWA_ATTN),
                 (unsigned)bw * h * NT * (lk + S), bad, d.guard != 0);
  }
  dense_rows<T>(s.att, c, 0, NT, c, a.proj_w, c, a.proj_b, c, 1, s.o, c);
  __syncthreads();
  if (d.train && d.drop_on) {
    for (int i = threadIdx.x; i < NT * c; i += blockDim.x)
      s.o[i] = rnd<T>(drop(d, SWA_PROJ, (unsigned)(bw * NT * c + i), s.o[i]));
    __syncthreads();
  }
}

}  // namespace qv
