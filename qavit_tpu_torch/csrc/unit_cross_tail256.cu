// Unit 4 of the fused block at n = 256 (qavit_v2_extreme_tin), forward
// (eval and train) and backward: the cross branch and the block's tail.
//
// Replaces the TPU kernels qavit_tpu/kernels/fused_pallas.py:190 fwd_call
// and :244 bwd_call for the core `cross_tail` (fused_kernels.py:96) at 256
// tokens: the tokens' attention over the projected bank, per-branch LN
// and compress, the softmax fusion, the bottleneck MLP; norm2, the
// CCF-FFN with its 3x3 depthwise conv on the 16 x 16 grid, gamma,
// drop-path.
//
// Everything but the dwconv works row by row; the dwconv reaches one grid
// row past any tile of rows.  The unit runs as a sequence of the
// n256_ops.cuh kernels on the caller's stream, every intermediate bf16 at
// the plain version's rounding points (fused_ref.cross_ref, tail_ref):
//   q, kbp, vbp -> attn_kernel<48> (guard: att zero) -> cross = dropout(
//   dense(att)); the four branch LNs (ln_kernel); each compress into its
//   48 columns of the fused rows times its fusion weight; h = dropout(
//   gelu(dense(fused))); x1 = x + drop_path(dropout(dense(h))); g =
//   gelu(dense(norm2(x1))); hh = LN(g); the dwconv (map: 9 taps, bias,
//   scale); h2 = LN(.); y = x1 + drop_path(gamma dropout(dense(h2)))
// (each dense on gemm_kernel with its epilogue).  The backward recomputes
// the forward, saving the values its VJP reads, and walks it back: fc2,
// the LNs, the dwconv (dwconv_bwd_kernel, a slice of the samples a block,
// a thread a channel), fc1, norm2, the bottleneck, the fusion weights
// (ct_sums_kernel), the compresses, the branch LNs, the cross proj, the
// attention (attn_bwd_*), q and the bank's projections per slice.
#include "cross_tail_mma.cuh"
#include "n256_ops.cuh"

namespace qv {

constexpr int XC = 192, XH = 96, XS = 256, XSIDE = 16;

struct FusionWF {        // the softmax fusion weights [4]
  const float* logits;
  float* fw;
  __device__ void operator()(int) const {
    float mx = logits[0];
    for (int i = 1; i < 4; ++i) mx = fmaxf(mx, logits[i]);
    float e[4], s = 0.f;
    for (int i = 0; i < 4; ++i) {
      e[i] = expf(logits[i] - mx);
      s += e[i];
    }
    for (int i = 0; i < 4; ++i) fw[i] = e[i] / s;
  }
};

// the 3x3 depthwise correlation on each sample's 16 x 16 grid (zero halo),
// the nine products added in fused_ref's order, each product and sum
// rounded as its float32 ops round them, then rounded to bf16; the bias
// (rounded); y2 saved; times the rounded scale
struct DwconvF {
  const bf16* hh;
  const float* w;
  const float* b;         // (optional)
  const float* scale;
  bf16* y2;
  bf16* out;
  __device__ void operator()(int i) const {
    const int ch = (int)(i % XH);
    const int bp = i / XH;
    const int pix = (int)(bp % XS);
    const size_t base = bp - pix;
    const int gi = pix / XSIDE, gj = pix % XSIDE;
    float acc = 0.f;
    for (int ki = 0; ki < 3; ++ki)
      for (int kj = 0; kj < 3; ++kj) {
        const int si = gi + ki - 1, sj = gj + kj - 1;
        if (si >= 0 && si < XSIDE && sj >= 0 && sj < XSIDE)
          acc = add_rn(acc, mul_rn(bf(hh + (base + si * XSIDE + sj) * XH +
                                      ch),
                                   w[ch * 9 + ki * 3 + kj]));
      }
    float v = rnd<bf16>(acc);
    if (b) v = rnd<bf16>(v + rnd<bf16>(b[ch]));
    y2[i] = from_f<bf16>(v);
    out[i] = from_f<bf16>(v * rnd<bf16>(scale[ch]));
  }
};

struct Ct256 {
  float* fw;
  bf16 *bank_r, *q, *kbp, *vbp, *att, *br3, *nrm, *comp, *fused, *z1, *hb,
      *x1, *n2, *z2, *g2, *hh, *y2, *sv, *h2, *f;
};

static void ct256_bufs(QvBump& m, const Dims& d, Ct256& s) {
  const size_t M = (size_t)d.B * d.n, S = d.bank_s;
  s.fw = m.take<float>(4);
  s.bank_r = m.take<bf16>(2 * S * XC);
  s.kbp = m.take<bf16>(S * XC);
  s.vbp = m.take<bf16>(S * XC);
  for (bf16** p : {&s.q, &s.att, &s.br3, &s.comp, &s.fused, &s.x1, &s.n2,
                   &s.f})
    *p = m.take<bf16>(M * XC);
  s.nrm = m.take<bf16>(4 * M * XC);
  for (bf16** p : {&s.z1, &s.hb, &s.z2, &s.g2, &s.hh, &s.y2, &s.sv, &s.h2})
    *p = m.take<bf16>(M * XH);
}

static AttnGeom ct256_geom(const Dims& d, const Ct256& s) {
  AttnGeom g{};
  g.q = s.q;
  g.ks = s.kbp;
  g.vs = s.vbp;
  g.ldq = g.ldks = g.ldo = XC;
  g.B = d.B;
  g.nq = d.n;
  g.nko = 0;
  g.nks = d.bank_s;
  g.VH = g.H = d.heads;
  g.D = XC / d.heads;
  return g;
}

// the forward into s (and y): `bad` the flag array the attention's NaN
// check sets ([1]), `flag` the one whose [1] zeroes the attention output
static int ct256_run(const CrossTailArgs& a, const bf16* w1, const bf16* w2,
                     const Ct256& s, int* bad, const int* flag,
                     void* stream) {
  const Dims& d = a.d;
  const int M = d.B * d.n, S = d.bank_s;
  const bf16* x = static_cast<const bf16*>(a.x);
  const bf16* xn = static_cast<const bf16*>(a.xn);
  QV_TRY(qv_map(1, FusionWF{a.fusion, s.fw}, stream));
  QV_TRY(qv_map(S * XC, QvToBf16{a.bank_k, s.bank_r}, stream));
  QV_TRY(qv_map(S * XC, QvToBf16{a.bank_v, s.bank_r + S * XC}, stream));
  // the cross branch
  QV_TRY(qv_gemm(xn, XC, w1 + CT_CQ, CT_W1, M, XC, XC,
                 dense_epi(s.q, XC, a.cq_b), stream));
  QV_TRY(qv_gemm(s.bank_r, XC, w1 + CT_CK, CT_W1, S, XC, XC,
                 dense_epi(s.kbp, XC, a.ck_b), stream));
  QV_TRY(qv_gemm(s.bank_r + S * XC, XC, w1 + CT_CK + XC, CT_W1, S, XC, XC,
                 dense_epi(s.vbp, XC, a.cv_b), stream));
  AttnArgs at{ct256_geom(d, s), s.att, qv_drop(d, CROSS_ATTN), d.guard,
              bad + 1};
  QV_TRY(qv_attn<48>(at, stream));
  QV_TRY(qv_map((long long)M * XC, QvZeroIf{s.att, flag}, stream));
  EpiDense e = dense_epi(s.br3, XC, a.cp_b);
  e.mk = row_masks(d, CROSS_PROJ, XC);
  QV_TRY(qv_gemm(s.att, XC, w1 + CT_CP, CT_W1, M, XC, XC, e, stream));
  // per-branch LN, compress, the fused rows
  const bf16* br[4] = {static_cast<const bf16*>(a.swa),
                       static_cast<const bf16*>(a.msda),
                       static_cast<const bf16*>(a.cga), s.br3};
  for (int i = 0; i < 4; ++i) {
    bf16* nrm = s.nrm + (size_t)i * M * XC;
    QV_TRY(qv_ln(br[i], XC, nrm, XC, M, XC, a.norm_s[i], a.norm_b[i],
                 stream));
    e = dense_epi(s.fused, XC, a.comp_b[i]);
    e.ocol = CT_DC * i;
    e.pre = s.comp;
    e.mul = s.fw + i;
    QV_TRY(qv_gemm(nrm, XC, w1 + CT_COMP + CT_DC * i, CT_W1, M, CT_DC, XC, e,
                   stream));
  }
  // the bottleneck MLP and the first residual
  e = dense_epi(s.hb, XH, a.bn1_b);
  e.pre = s.z1;
  e.gelu = 1;
  e.mk = row_masks(d, BN1, XH);
  QV_TRY(qv_gemm(s.fused, XC, w1 + CT_BN1, CT_W1, M, XH, XC, e, stream));
  e = dense_epi(s.x1, XC, a.bn2_b);
  e.mk = row_masks(d, BN2, XC);
  with_path(e.mk, d, DP1);
  e.res = x;
  QV_TRY(qv_gemm(s.hb, XH, w2 + CT_BN2, CT_W2, M, XC, XH, e, stream));
  // the CCF-FFN and the second residual
  QV_TRY(qv_ln(s.x1, XC, s.n2, XC, M, XC, a.norm2_s, a.norm2_b, stream));
  e = dense_epi(s.g2, XH, a.fc1_b);
  e.pre = s.z2;
  e.gelu = 1;
  QV_TRY(qv_gemm(s.n2, XC, w1 + CT_FC1, CT_W1, M, XH, XC, e, stream));
  QV_TRY(qv_ln(s.g2, XH, s.hh, XH, M, XH, a.dwn_s, a.dwn_b, stream));
  QV_TRY(qv_map((long long)M * XH,
                DwconvF{s.hh, a.dw_w, d.dw_bias ? a.dw_b : nullptr,
                        a.dw_scale, s.y2, s.sv},
                stream));
  QV_TRY(qv_ln(s.sv, XH, s.h2, XH, M, XH, a.pdn_s, a.pdn_b, stream));
  e = dense_epi(static_cast<bf16*>(a.y), XC, a.fc2_b);
  e.mk = row_masks(d, FFN, XC);
  with_path(e.mk, d, DP2);
  e.gamma = a.gamma;
  e.res = s.x1;
  e.post = s.f;
  return qv_gemm(s.h2, XH, w2 + CT_FC2, CT_W2, M, XC, XH, e, stream);
}

static size_t ct256_fwd_bytes(const Dims& d) {
  QvBump m{nullptr};
  Ct256 s;
  ct256_bufs(m, d, s);
  return m.used;
}

static int ct256_forward(const CrossTailArgs& a, const bf16* w1,
                         const bf16* w2, void* scratch, void* stream) {
  QvBump m{static_cast<char*>(scratch)};
  Ct256 s;
  ct256_bufs(m, a.d, s);
  return ct256_run(a, w1, w2, s, a.ws, a.ws, stream);
}

// --- the backward -----------------------------------------------------------

struct Ct256B {
  float *dx1, *dh2, *ds, *dhh, *dg2, *dn2, *dhb, *dfused, *dn, *dbr3, *datt,
      *dq, *dks, *dvs, *dkp, *dvp;
  bf16 *dzb, *dz2b, *dz3b, *dz1b, *dcompb, *dcpb, *dqb;
  int* bad;
};

static void ct256_bwd_bufs(QvBump& m, const Dims& d, Ct256& s, Ct256B& t) {
  const size_t M = (size_t)d.B * d.n, S = d.bank_s;
  ct256_bufs(m, d, s);
  for (float** p : {&t.dx1, &t.dn2, &t.dfused, &t.dn, &t.dbr3, &t.datt,
                    &t.dq})
    *p = m.take<float>(M * XC);
  for (float** p : {&t.dh2, &t.ds, &t.dhh, &t.dg2, &t.dhb})
    *p = m.take<float>(M * XH);
  for (bf16** p : {&t.dzb, &t.dz3b, &t.dcompb, &t.dcpb, &t.dqb})
    *p = m.take<bf16>(M * XC);
  for (bf16** p : {&t.dz2b, &t.dz1b}) *p = m.take<bf16>(M * XH);
  t.dks = m.take<float>((size_t)d.B * d.heads * S * (XC / d.heads));
  t.dvs = m.take<float>((size_t)d.B * d.heads * S * (XC / d.heads));
  t.dkp = m.take<float>((size_t)d.grid * S * XC);
  t.dvp = m.take<float>((size_t)d.grid * S * XC);
  t.bad = m.take<int>(2);
}

static size_t ct256_bwd_bytes(const Dims& d) {
  QvBump m{nullptr};
  Ct256 s;
  Ct256B t;
  ct256_bwd_bufs(m, d, s, t);
  return m.used;
}

// d(y) -> d(x1) (the residual) and rnd(d(fc2's dense)): through the
// drop-path, gamma and the FFN dropout, each cotangent rounded to bf16
// where autograd of the plain version rounds it (the bf16 tensor it
// meets)
struct FfnBwdF {
  const bf16* dy;
  const float* gamma;
  RowMasks mk;
  float* dx1;
  bf16* dz;
  __device__ void operator()(int i) const {
    const int r = (int)(i / XC), c = (int)(i % XC);
    const float g = bf(dy + i);
    dx1[i] = g;
    const float dg = rnd<bf16>(rnd<bf16>(g * mk.path(r)) * gamma[0]);
    dz[i] = from_f<bf16>(mk.drop_bwd(r, c, dg));
  }
};

// d(x1) -> rnd(d(bottleneck fc2's dense)): the drop-path and dropout
struct Bn2BwdF {
  const float* dx1;
  RowMasks mk;
  bf16* dz;
  __device__ void operator()(int i) const {
    const int r = (int)(i / XC), c = (int)(i % XC);
    const float g = rnd<bf16>(rnd<bf16>(dx1[i]) * mk.path(r));
    dz[i] = from_f<bf16>(mk.drop_bwd(r, c, g));
  }
};

// d(gelu(z) through a dropout) -> rnd(d(z))
struct GeluBwdF {
  const float* dh;
  const bf16* z;
  RowMasks mk;
  bf16* dz;
  __device__ void operator()(int i) const {
    const int r = (int)(i / XH), c = (int)(i % XH);
    dz[i] = from_f<bf16>(mk.drop_bwd(r, c, dh[i]) * gelu_grad(bf(z + i)));
  }
};

struct FusedBwdF {       // d(compress_i) = rnd(d(fused)) fw_i
  const float* dfused;
  const float* fw;
  bf16* dcomp;
  __device__ void operator()(int i) const {
    dcomp[i] = from_f<bf16>(rnd<bf16>(dfused[i]) * fw[(i % XC) / CT_DC]);
  }
};

struct DropBwdF {        // rnd(drop_bwd(g)) of a float32 cotangent
  const float* g;
  RowMasks mk;
  bf16* out;
  __device__ void operator()(int i) const {
    const int r = (int)(i / mk.width), c = (int)(i % mk.width);
    out[i] = from_f<bf16>(mk.drop_bwd(r, c, g[i]));
  }
};

// d(gamma) (mode 0: sum of rnd(d(y) path(r)) f) or d(fusion logits)
// (mode 1: per branch i the sum of rnd(d(fused)) comp over its 48
// columns, through the softmax's VJP, linear in those sums) over slice
// p's rows, added to the slice; a warp a row.  Both are sums with
// cancellation over the batch, so the cotangent is rounded where
// autograd of the plain version rounds it.
struct CtSumsArgs {
  const bf16* dy;
  const float* dfused;
  const bf16* v;          // f (mode 0) or comp (mode 1)
  const float* fw;
  RowMasks mk;
  float* gws;
  int wstride, off, M, P, mode;
};

template <int = 0>
__global__ void __launch_bounds__(NTHREADS) ct_sums_kernel(CtSumsArgs a) {
  __shared__ float red[8][4];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int p = blockIdx.x; p < a.P; p += gridDim.x) {
    int lo, hi;
    split_rows(a.M, a.P, p, lo, hi);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int r = lo + warp; r < hi; r += 8) {
      const float pr = a.mode == 0 ? a.mk.path(r) : 1.f;
      for (int c = lane; c < XC; c += 32) {
        const size_t i = (size_t)r * XC + c;
        const float g = rnd<bf16>(a.mode == 0 ? bf(a.dy + i) * pr
                                              : a.dfused[i]);
        acc[a.mode == 0 ? 0 : c / CT_DC] += g * bf(a.v + i);
      }
    }
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], o);
      if (lane == 0) red[warp][k] = acc[k];
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float t[4] = {0.f, 0.f, 0.f, 0.f};
      for (int w = 0; w < 8; ++w)
        for (int k = 0; k < 4; ++k) t[k] += red[w][k];
      float* sl = a.gws + (size_t)p * a.wstride + a.off;
      if (a.mode == 0) {
        sl[0] += t[0];
      } else {
        float dot = 0.f;
        for (int k = 0; k < 4; ++k) dot += a.fw[k] * t[k];
        for (int k = 0; k < 4; ++k) sl[k] += a.fw[k] * (t[k] - dot);
      }
    }
    __syncthreads();
  }
}

// the dwconv's VJP from d(its scaled output) ds: d(y2) = ds rnd(scale),
// d(scale) = sum ds y2, d(bias) = sum d(y2), d(w) = sum hh-window d(y2),
// d(hh) = the transposed correlation of d(y2); a block a slice of the
// samples, a thread a channel
struct DwBwdArgs {
  const float* ds;
  const bf16* y2;
  const bf16* hh;
  const float* w;
  const float* scale;
  float* dhh;
  float* gws;
  int wstride, off_w, off_s, off_b, B, P;
};

template <int = 0>
__global__ void __launch_bounds__(NTHREADS) dwconv_bwd_kernel(DwBwdArgs a) {
  const int ch = threadIdx.x;
  if (ch >= XH) return;
  const float sc = rnd<bf16>(a.scale[ch]);
  float wt[9];
  for (int k = 0; k < 9; ++k) wt[k] = a.w[ch * 9 + k];
  for (int p = blockIdx.x; p < a.P; p += gridDim.x) {
    int lo, hi;
    split_rows(a.B, a.P, p, lo, hi);
    float gw[9] = {}, gs = 0.f, gb = 0.f;
    for (int b = lo; b < hi; ++b) {
      const size_t base = (size_t)b * XS;
      auto dy2 = [&](int si, int sj) {
        return a.ds[(base + si * XSIDE + sj) * XH + ch] * sc;
      };
      for (int pix = 0; pix < XS; ++pix) {
        const int gi = pix / XSIDE, gj = pix % XSIDE;
        const size_t at = (base + pix) * XH + ch;
        const float g = dy2(gi, gj);
        gs += a.ds[at] * bf(a.y2 + at);
        gb += g;
        float dh = 0.f;
        for (int ki = 0; ki < 3; ++ki)
          for (int kj = 0; kj < 3; ++kj) {
            const int si = gi + ki - 1, sj = gj + kj - 1;
            if (si >= 0 && si < XSIDE && sj >= 0 && sj < XSIDE)
              gw[ki * 3 + kj] =
                  fmaf(bf(a.hh + (base + si * XSIDE + sj) * XH + ch), g,
                       gw[ki * 3 + kj]);
            const int ti = gi - ki + 1, tj = gj - kj + 1;
            if (ti >= 0 && ti < XSIDE && tj >= 0 && tj < XSIDE)
              dh = fmaf(wt[ki * 3 + kj], dy2(ti, tj), dh);
          }
        a.dhh[at] = dh;
      }
    }
    float* sl = a.gws + (size_t)p * a.wstride;
    for (int k = 0; k < 9; ++k) sl[a.off_w + ch * 9 + k] += gw[k];
    sl[a.off_s + ch] += gs;
    if (a.off_b >= 0) sl[a.off_b + ch] += gb;
  }
}

// w: bf16 w1 [C, CT_W1], w2 [HID, CT_W2], w1^T [CT_W1, C], w2^T [CT_W2, HID]
static int ct256_backward(const CrossTailBwdArgs& a, const bf16* w,
                          void* scratch, void* stream) {
  const CrossTailArgs& f = a.f;
  const Dims& d = f.d;
  const CrossTailGrads& gr = a.g;
  const int P = d.grid, M = d.B * d.n, S = d.bank_s;
  const bf16* w1 = w;
  const bf16* w2 = w1 + XC * CT_W1;
  const bf16* w1t = w2 + XH * CT_W2;
  const bf16* w2t = w1t + CT_W1 * XC;
  float* gws = a.c.gws;
  const int ws = a.c.wstride;
  auto off = [&](float* field) { return (int)(field - gws); };
  QvBump m{static_cast<char*>(scratch)};
  Ct256 s;
  Ct256B t;
  ct256_bwd_bufs(m, d, s, t);
  Ct256 s2 = s;      // the recompute's own output in place of y
  CrossTailArgs fa = f;
  fa.y = t.dzb;      // overwritten below, after its last read
  QV_TRY(ct256_run(fa, w1, w2, s2, t.bad, a.c.flag, stream));
  const long long MC = (long long)M * XC, MH = (long long)M * XH;
  // y = x1 + drop_path(gamma dropout(dense(h2)))
  RowMasks mk = row_masks(d, FFN, XC);
  with_path(mk, d, DP2);
  const bf16* dy = static_cast<const bf16*>(a.d_y);
  QV_TRY(qv_map(MC, FfnBwdF{dy, f.gamma, mk, t.dx1, t.dzb}, stream));
  CtSumsArgs cs{dy, nullptr, s.f, s.fw, mk, gws, ws, off(gr.gamma), M, P, 0};
  QV_TRY(qv_launch(ct_sums_kernel<>, cs, 0, stream, qv_grid(P)));
  QV_TRY(qv_wgrad(s.h2, XH, t.dzb, XC, M, XH, XC, P, gws, ws, gr.fc2_w, XC,
                  gr.fc2_b, stream));
  QV_TRY(qv_gemm(t.dzb, XC, w2t + CT_FC2 * XH, XH, M, XH, XC,
                 EpiF32{t.dh2, XH, 0, 0}, stream));
  QV_TRY(qv_ln_bwd(s.sv, XH, t.dh2, XH, t.ds, nullptr, XH, 0, M, XH, P,
                   f.pdn_s, gws, ws, gr.pdn_s, gr.pdn_b, stream));
  // the dwconv
  QV_TRY(qv_launch(dwconv_bwd_kernel<>,
                   DwBwdArgs{t.ds, s.y2, s.hh, f.dw_w, f.dw_scale, t.dhh, gws,
                             ws, off(gr.dw_w), off(gr.dw_scale),
                             d.dw_bias && gr.dw_b ? off(gr.dw_b) : -1, d.B,
                             P},
                   0, stream, qv_grid(P)));
  QV_TRY(qv_ln_bwd(s.g2, XH, t.dhh, XH, t.dg2, nullptr, XH, 0, M, XH, P,
                   f.dwn_s, gws, ws, gr.dwn_s, gr.dwn_b, stream));
  QV_TRY(qv_map(MH, GeluBwdF{t.dg2, s.z2, row_masks(d, -1, XH), t.dz2b},
                stream));
  QV_TRY(qv_wgrad(s.n2, XC, t.dz2b, XH, M, XC, XH, P, gws, ws, gr.fc1_w, XH,
                  gr.fc1_b, stream));
  QV_TRY(qv_gemm(t.dz2b, XH, w1t + CT_FC1 * XC, XC, M, XC, XH,
                 EpiF32{t.dn2, XC, 0, 0}, stream));
  QV_TRY(qv_ln_bwd(s.x1, XC, t.dn2, XC, t.dx1, nullptr, XC, 1, M, XC, P,
                   f.norm2_s, gws, ws, gr.norm2_s, gr.norm2_b, stream));
  QV_TRY(qv_map(MC, QvToBf16{t.dx1, static_cast<bf16*>(a.d_x)}, stream));
  // x1 = x + drop_path(dropout(dense(h)))
  mk = row_masks(d, BN2, XC);
  with_path(mk, d, DP1);
  QV_TRY(qv_map(MC, Bn2BwdF{t.dx1, mk, t.dz3b}, stream));
  QV_TRY(qv_wgrad(s.hb, XH, t.dz3b, XC, M, XH, XC, P, gws, ws, gr.bn2_w, XC,
                  gr.bn2_b, stream));
  QV_TRY(qv_gemm(t.dz3b, XC, w2t + CT_BN2 * XH, XH, M, XH, XC,
                 EpiF32{t.dhb, XH, 0, 0}, stream));
  QV_TRY(qv_map(MH, GeluBwdF{t.dhb, s.z1, row_masks(d, BN1, XH), t.dz1b},
                stream));
  QV_TRY(qv_wgrad(s.fused, XC, t.dz1b, XH, M, XC, XH, P, gws, ws, gr.bn1_w,
                  XH, gr.bn1_b, stream));
  QV_TRY(qv_gemm(t.dz1b, XH, w1t + CT_BN1 * XC, XC, M, XC, XH,
                 EpiF32{t.dfused, XC, 0, 0}, stream));
  // the fusion, the compresses and the branch LNs
  cs = CtSumsArgs{nullptr, t.dfused, s.comp, s.fw, mk, gws, ws,
                  off(gr.fusion), M, P, 1};
  QV_TRY(qv_launch(ct_sums_kernel<>, cs, 0, stream, qv_grid(P)));
  QV_TRY(qv_map(MC, FusedBwdF{t.dfused, s.fw, t.dcompb}, stream));
  const bf16* br[4] = {static_cast<const bf16*>(f.swa),
                       static_cast<const bf16*>(f.msda),
                       static_cast<const bf16*>(f.cga), s.br3};
  bf16* dbr[3] = {static_cast<bf16*>(a.d_swa), static_cast<bf16*>(a.d_msda),
                  static_cast<bf16*>(a.d_cga)};
  for (int i = 0; i < 4; ++i) {
    const bf16* nrm = s.nrm + (size_t)i * M * XC;
    QV_TRY(qv_wgrad(nrm, XC, t.dcompb + CT_DC * i, XC, M, XC, CT_DC, P, gws,
                    ws, gr.comp_w[i], CT_DC, gr.comp_b[i], stream));
    QV_TRY(qv_gemm(t.dcompb + CT_DC * i, XC, w1t + (CT_COMP + CT_DC * i) * XC,
                   XC, M, XC, CT_DC, EpiF32{t.dn, XC, 0, 0}, stream));
    QV_TRY(qv_ln_bwd(br[i], XC, t.dn, XC, i < 3 ? nullptr : t.dbr3,
                     i < 3 ? dbr[i] : nullptr, XC, 0, M, XC, P, f.norm_s[i],
                     gws, ws, gr.norm_s[i], gr.norm_b[i], stream));
  }
  // the cross branch
  QV_TRY(qv_map(MC, DropBwdF{t.dbr3, row_masks(d, CROSS_PROJ, XC), t.dcpb},
                stream));
  QV_TRY(qv_wgrad(s.att, XC, t.dcpb, XC, M, XC, XC, P, gws, ws, gr.cp_w, XC,
                  gr.cp_b, stream));
  QV_TRY(qv_gemm(t.dcpb, XC, w1t + CT_CP * XC, XC, M, XC, XC,
                 EpiF32{t.datt, XC, 0, 0}, stream));
  AttnBwdArgs ab{ct256_geom(d, s), t.datt, t.dq, nullptr, nullptr, t.dks,
                 t.dvs, nullptr, XC, XC, qv_drop(d, CROSS_ATTN), a.c.flag};
  QV_TRY(qv_attn_bwd<48>(ab, stream));
  QV_TRY(qv_map(2LL * P * S * XC, QvZero{t.dkp}, stream));
  const int hd = XC / d.heads;
  QV_TRY(qv_launch(shared_sum_kernel<>,
                   SharedSumArgs{t.dks, t.dkp, (size_t)S * XC, d.B, d.heads,
                                 d.heads, hd, S, P},
                   0, stream, qv_grid(P)));
  QV_TRY(qv_launch(shared_sum_kernel<>,
                   SharedSumArgs{t.dvs, t.dvp, (size_t)S * XC, d.B, d.heads,
                                 d.heads, hd, S, P},
                   0, stream, qv_grid(P)));
  QV_TRY(qv_launch(bank_proj_bwd_kernel<>,
                   BankProjBwdArgs{f.bank_k, f.ck_w, t.dkp, gws, ws,
                                   off(gr.ck_w), off(gr.ck_b),
                                   off(gr.bank_k), S, XC, XC, P},
                   0, stream, qv_grid(P)));
  QV_TRY(qv_launch(bank_proj_bwd_kernel<>,
                   BankProjBwdArgs{f.bank_v, f.cv_w, t.dvp, gws, ws,
                                   off(gr.cv_w), off(gr.cv_b),
                                   off(gr.bank_v), S, XC, XC, P},
                   0, stream, qv_grid(P)));
  QV_TRY(qv_map(MC, QvToBf16{t.dq, t.dqb}, stream));
  QV_TRY(qv_wgrad(static_cast<const bf16*>(f.xn), XC, t.dqb, XC, M, XC, XC,
                  P, gws, ws, gr.cq_w, XC, gr.cq_b, stream, a.c.flag));
  QV_TRY(qv_gemm(t.dqb, XC, w1t + CT_CQ * XC, XC, M, XC, XC,
                 EpiBf16{static_cast<bf16*>(a.d_xn), XC, 0}, stream));
  return qv_reduce(gws, a.c.grad, P, ws, d.rgrid, stream);
}

}  // namespace qv

static bool qv_ct256(const qv::Dims& d) {
  return qv_n256(d) && d.stab_ccf && d.stab_dw;
}

// bf16 at n = 256 (qv_n256, stabilized CCF-FFN and dwconv): `a` as for
// qv_unit_cross_tail, w1 and w2 as for qv_unit_cross_tail_mma, a scratch
// of qv_unit_cross_tail_mma256_scratch(d) floats; eval, and (the train
// entry) training, whose masks and drop-paths come from d.
extern "C" int qv_unit_cross_tail_mma256(const qv::CrossTailArgs* a,
                                         const void* w1, const void* w2,
                                         void* scratch, int is_bf16,
                                         void* stream) {
  if (!is_bf16 || !qv_ct256(a->d) || a->d.train) return qv::ERR_ARGS;
  return qv::ct256_forward(*a, static_cast<const qv::bf16*>(w1),
                           static_cast<const qv::bf16*>(w2), scratch, stream);
}

extern "C" int qv_unit_cross_tail_mma_train256(const qv::CrossTailArgs* a,
                                               const void* w1, const void* w2,
                                               void* scratch, int is_bf16,
                                               void* stream) {
  if (!is_bf16 || !qv_ct256(a->d) || !a->d.train) return qv::ERR_ARGS;
  return qv::ct256_forward(*a, static_cast<const qv::bf16*>(w1),
                           static_cast<const qv::bf16*>(w2), scratch, stream);
}

extern "C" int qv_unit_cross_tail_mma256_smem(const qv::Dims*) {
  return qv::GM_SMEM;
}
extern "C" int qv_unit_cross_tail_mma_train256_smem(const qv::Dims*) {
  return qv::GM_SMEM;
}
extern "C" int qv_unit_cross_tail_mma256_scratch(const qv::Dims* d) {
  return (int)((qv::ct256_fwd_bytes(*d) + 3) / 4);
}
extern "C" int qv_unit_cross_tail_mma_train256_scratch(const qv::Dims* d) {
  return (int)((qv::ct256_fwd_bytes(*d) + 3) / 4);
}

// the backward at n = 256: `a` as for qv_unit_cross_tail_bwd with the
// bf16 weights beside it (w1, w2, then both transposed) and a scratch of
// qv_unit_cross_tail_bwd_mma256_scratch(d) floats
extern "C" int qv_unit_cross_tail_bwd_mma256(const qv::CrossTailBwdArgs* a,
                                             const void* w, void* scratch,
                                             int is_bf16, void* stream) {
  if (!is_bf16 || !qv_ct256(a->f.d)) return qv::ERR_ARGS;
  return qv::ct256_backward(*a, static_cast<const qv::bf16*>(w), scratch,
                            stream);
}
extern "C" int qv_unit_cross_tail_bwd_mma256_smem(const qv::Dims*) {
  return (2 * 256 * 48 + 3 * 256) * 4;     // attn_bwd_k_kernel<48>
}
extern "C" int qv_unit_cross_tail_bwd_mma256_scratch(const qv::Dims* d) {
  return (int)((qv::ct256_bwd_bytes(*d) + 3) / 4);
}
