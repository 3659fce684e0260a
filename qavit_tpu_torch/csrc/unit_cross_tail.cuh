// The per-sample body of unit 4 (cross branch + block tail), shared by the
// forward kernel (unit_cross_tail.cu) and the backward kernel
// (unit_cross_tail_bwd.cu).
#pragma once
#include "common.cuh"

namespace qv {

struct CrossTailBufs {
  float* xn;     // [NT, c] the input xn
  float* qc;     // [NT, c] cross q
  float* kb;     // [S, c] projected bank k (per block, cross_tail_prologue)
  float* vb;     // [S, c]
  float* attc;   // [NT, c] cross attention output
  float* X;      // [NT, c] cross proj output after dropout
  float* sc;     // [heads, NT, S] probabilities
  float* pr;     // the probabilities used for PV (may equal sc)
  float* nrm;    // [NT, c] LN_i of a branch output
  float* cc;     // [NT, c] the four compressed branches, before the weights
  float* fused;  // [NT, c] the weighted concat (may equal cc)
  float* h1;     // [NT, hb] bottleneck fc1 output
  float* g1;     // [NT, hb] GELU, then dropout (may equal h1)
  float* y2;     // [NT, c] bottleneck output after dropout and drop path
  float* x1;     // [NT, c] x, then x + y2
  float* fin;    // [NT, c] norm2(x1)
  float* h;      // [NT, hc] fc1 output
  float* hg;     // [NT, hc] GELU (may equal h)
  float* hn;     // [NT, hc] dwconv_norm (stab_ccf; may equal hg)
  float* dwb;    // [NT, hc] dwconv (+ bias)
  float* dws;    // [NT, hc] x scale (stab_dw; may equal dwb)
  float* hp;     // [NT, hc] post_dwconv_norm (stab_ccf; may equal dws)
  float* z;      // [NT, c] fc2 output after dropout
  float* y;      // [NT, c] the block output, float32 before rounding
  float* stats;  // 2*NT
};

// The cross branch's bank K/V projections are the same for every sample:
// once per block.  bk, bv: [S, c] bank rows rounded to the working type.
template <typename T>
__device__ void cross_tail_prologue(const CrossTailArgs& a, const float* bk,
                                    const float* bv, const CrossTailBufs& s) {
  const int c = a.d.c, S = a.d.bank_s;
  dense_rows<T>(bk, c, 0, S, c, a.ck_w, c, a.ck_b, c, 1, s.kb, c);
  dense_rows<T>(bv, c, 0, S, c, a.cv_w, c, a.cv_b, c, 1, s.vb, c);
  __syncthreads();
}

__device__ __forceinline__ void fusion_weights(const float* logits,
                                               float* w) {
  float m = logits[0];
  for (int i = 1; i < 4; ++i) m = fmaxf(m, logits[i]);
  float sum = 0.f;
  for (int i = 0; i < 4; ++i) {
    w[i] = expf(logits[i] - m);
    sum += w[i];
  }
  for (int i = 0; i < 4; ++i) w[i] = w[i] / sum;
}

// The rows [row0, row0 + NT) of sample b up to the input of the CCF-FFN's
// dwconv (dwconv_norm's output with stab_ccf, else the GELU), which this
// returns: the cross branch, the fusion tail, the first residual, norm2,
// fc1 and GELU.  Every step is row by row, so a sample of n > NT tokens
// runs as n / NT tiles (eval only: the attention dropout's mask index
// assumes the whole sample, row0 = 0).
template <typename T>
__device__ const float* cross_tail_front(const CrossTailArgs& a, int b,
                                         int row0, bool zero_attn,
                                         const CrossTailBufs& s, int* bad) {
  const Dims& d = a.d;
  const int c = d.c, S = d.bank_s, h = d.heads;
  const int hb = d.bottleneck_hidden, hc = d.ccf_hidden, dc = d.d_c;
  const int t0 = b * d.n + row0;          // flat token index of row 0
  const size_t off = (size_t)t0 * c;

  // ---- cross branch --------------------------------------------------
  load_tile<T>(s.xn, static_cast<const T*>(a.xn) + off, NT * c);
  __syncthreads();
  dense_rows<T>(s.xn, c, 0, NT, c, a.cq_w, c, a.cq_b, c, 1, s.qc, c);
  __syncthreads();
  if (zero_attn) {
    fill(s.attc, NT * c, 0.f);
    __syncthreads();
  } else {
    attention<T>(s.qc, c, NT, h, c / h, s.kb, s.vb, c, S, nullptr, nullptr, c,
                 0, h, s.attc, c, s.sc, s.pr, attn_drop(d, CROSS_ATTN),
                 (unsigned)b * h * NT * S, bad, d.guard != 0);
  }
  dense_rows<T>(s.attc, c, 0, NT, c, a.cp_w, c, a.cp_b, c, 1, s.X, c);
  __syncthreads();
  if (d.train && d.drop_on) {
    for (int e = threadIdx.x; e < NT * c; e += blockDim.x)
      s.X[e] = rnd<T>(drop(d, CROSS_PROJ, (unsigned)(t0 * c + e), s.X[e]));
    __syncthreads();
  }

  // ---- tail: per-branch LN + compress, softmax-weighted concat -------
  float w[4];
  fusion_weights(a.fusion, w);
  const void* branch[3] = {a.swa, a.msda, a.cga};
  for (int i = 0; i < 4; ++i) {
    if (i < 3) {
      load_tile<T>(s.nrm, static_cast<const T*>(branch[i]) + off, NT * c);
      __syncthreads();
    }
    layer_norm_rows<T>(i < 3 ? s.nrm : s.X, c, s.nrm, c, NT, c, a.norm_s[i],
                       a.norm_b[i], s.stats);
    dense_rows<T>(s.nrm, c, 0, NT, c, a.comp_w[i], dc, a.comp_b[i], dc, 1,
                  s.cc + i * dc, c);
    __syncthreads();
    for (int e = threadIdx.x; e < NT * dc; e += blockDim.x) {
      const int p = (e / dc) * c + i * dc + (e % dc);
      s.fused[p] = rnd<T>(s.cc[p] * w[i]);
    }
    __syncthreads();
  }

  // ---- bottleneck MLP and the first residual -------------------------
  dense_rows<T>(s.fused, c, 0, NT, 4 * dc, a.bn1_w, hb, a.bn1_b, hb, 1, s.h1,
                hb);
  __syncthreads();
  for (int e = threadIdx.x; e < NT * hb; e += blockDim.x)
    s.g1[e] = rnd<T>(drop(d, BN1, (unsigned)(t0 * hb + e),
                          rnd<T>(gelu_f(s.h1[e]))));
  __syncthreads();
  dense_rows<T>(s.g1, hb, 0, NT, hb, a.bn2_w, c, a.bn2_b, c, 1, s.y2, c);
  load_tile<T>(s.x1, static_cast<const T*>(a.x) + off, NT * c);
  __syncthreads();
  const float m1 = drop_path_mul(d, DP1, b);
  for (int e = threadIdx.x; e < NT * c; e += blockDim.x) {
    float v = rnd<T>(drop(d, BN2, (unsigned)(t0 * c + e), s.y2[e]));
    if (d.train) v = rnd<T>(v * m1);
    s.y2[e] = v;
    s.x1[e] = rnd<T>(s.x1[e] + v);
  }
  __syncthreads();

  // ---- CCF-FFN up to the dwconv ---------------------------------------
  layer_norm_rows<T>(s.x1, c, s.fin, c, NT, c, a.norm2_s, a.norm2_b, s.stats);
  dense_rows<T>(s.fin, c, 0, NT, c, a.fc1_w, hc, a.fc1_b, hc, 1, s.h, hc);
  __syncthreads();
  gelu_rows<T>(s.h, s.hg, NT * hc);
  __syncthreads();
  if (!d.stab_ccf) return s.hg;
  layer_norm_rows<T>(s.hg, hc, s.hn, hc, NT, hc, a.dwn_s, a.dwn_b, s.stats);
  return s.hn;
}

// The 3x3 depthwise correlation (zero halo, bias before the 0.1 scale) of
// the rows [row0, row0 + NT) on the side x side grid; dwin: the sample's
// [n, ccf_hidden] dwconv input, every row of it.
template <typename T>
__device__ void ccf_dwconv(const CrossTailArgs& a, const float* dwin,
                           int row0, const CrossTailBufs& s) {
  const Dims& d = a.d;
  const int hc = d.ccf_hidden, side = d.side;
  for (int e = threadIdx.x; e < NT * hc; e += blockDim.x) {
    const int n = row0 + e / hc, ch = e % hc;
    const int gi = n / side, gj = n % side;
    const float* k = a.dw_w + ch * 9;
    float acc = 0.f;
    for (int ki = 0; ki < 3; ++ki) {
      for (int kj = 0; kj < 3; ++kj) {
        const int si = gi + ki - 1, sj = gj + kj - 1;
        const float v = (si >= 0 && si < side && sj >= 0 && sj < side)
                            ? dwin[(si * side + sj) * hc + ch]
                            : 0.f;
        acc = fmaf(v, k[ki * 3 + kj], acc);
      }
    }
    float yv = rnd<T>(acc);
    if (d.dw_bias) yv = rnd<T>(yv + rnd<T>(a.dw_b[ch]));
    s.dwb[e] = yv;
    if (d.stab_dw) yv = rnd<T>(yv * rnd<T>(a.dw_scale[ch]));
    s.dws[e] = yv;
  }
  __syncthreads();
}

// The rows [row0, row0 + NT) of sample b after the dwconv:
// post_dwconv_norm, fc2, gamma and the second residual into s.y.
template <typename T>
__device__ void cross_tail_back(const CrossTailArgs& a, int b, int row0,
                                const CrossTailBufs& s) {
  const Dims& d = a.d;
  const int c = d.c, hc = d.ccf_hidden;
  const int t0 = b * d.n + row0;
  const float* pin = s.dws;
  if (d.stab_ccf) {
    layer_norm_rows<T>(s.dws, hc, s.hp, hc, NT, hc, a.pdn_s, a.pdn_b, s.stats);
    pin = s.hp;
  }
  dense_rows<T>(pin, hc, 0, NT, hc, a.fc2_w, c, a.fc2_b, c, 1, s.z, c);
  __syncthreads();
  const float gamma = d.stab_ccf ? a.gamma[0] : 1.f;
  const float m2 = drop_path_mul(d, DP2, b);
  for (int e = threadIdx.x; e < NT * c; e += blockDim.x) {
    float f = rnd<T>(drop(d, FFN, (unsigned)(t0 * c + e), s.z[e]));
    s.z[e] = f;
    if (d.stab_ccf) f = rnd<T>(f * gamma);
    if (d.train) f = rnd<T>(f * m2);
    s.y[e] = s.x1[e] + f;
  }
  __syncthreads();
}

// One sample of n = NT tokens, every buffer holding the whole sample.
template <typename T>
__device__ void cross_tail_body(const CrossTailArgs& a, int b, bool zero_attn,
                                const CrossTailBufs& s, int* bad) {
  const float* dwin = cross_tail_front<T>(a, b, 0, zero_attn, s, bad);
  ccf_dwconv<T>(a, dwin, 0, s);
  cross_tail_back<T>(a, b, 0, s);
}

}  // namespace qv
