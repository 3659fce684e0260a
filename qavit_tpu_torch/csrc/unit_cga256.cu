// Unit 3 of the fused block at n = 256 (qavit_v2_extreme_tin), forward
// (eval and train) and backward: the CGA branch.
//
// Replaces the TPU kernels qavit_tpu/kernels/fused_pallas.py:190 fwd_call
// and :244 bwd_call for the core `cga` (fused_kernels.py:88) at 256
// tokens: 6 channel groups x 4 heads of width 4, 256 queries over the
// sample's 256 keys and the 16 projected bank keys a group-head, proj,
// dropout.
//
// Each query attends to all 256 tokens of its sample, so the unit runs as
// a sequence of the n256_ops.cuh kernels on the caller's stream:
//   q | k | v = dense(xn as [B n 6, 32]; W_qkv [32, 48])   gemm_kernel
//   kbp, vbp = dense(rnd(bank); W_bk, W_bv)                 gemm_kernel
//   att [B n, 96] = attention over 24 virtual heads of 4    attn_kernel<4>
//   out = dropout(dense(att; W_p [96, 192]))                gemm_kernel
// and in training the bank-write partials of out (bank256_kernel).  The
// backward recomputes the forward and takes the VJP step by step (proj,
// the attention, the grouped q | k | v, the bank projections per slice).
#include "n256_ops.cuh"

namespace qv {

constexpr int CA_C = 192, CA_G = 6, CA_CPG = 32, CA_PG = 16, CA_H = 4;
constexpr int CA_QKV = 3 * CA_PG, CA_GW = CA_G * CA_PG;

struct QkvBiasF {        // the packed bias [q_b | k_b | v_b]
  const float* q;
  const float* k;
  const float* v;
  float* out;
  __device__ void operator()(int i) const {
    const int j = (int)i;
    out[j] = j < CA_PG ? q[j] : j < 2 * CA_PG ? k[j - CA_PG] : v[j - 2 * CA_PG];
  }
};

struct Cga256 {
  float* bias;            // [48]
  bf16 *bank_r, *bkw, *bvw, *qkv, *kbp, *vbp, *att;
};

static void cga256_bufs(QvBump& m, const Dims& d, Cga256& s) {
  const size_t M = (size_t)d.B * d.n;
  s.bias = m.take<float>(CA_QKV);
  s.bank_r = m.take<bf16>(2 * d.bank_s * CA_C);
  s.bkw = m.take<bf16>(CA_C * CA_PG);
  s.bvw = m.take<bf16>(CA_C * CA_PG);
  s.qkv = m.take<bf16>(M * CA_G * CA_QKV);
  s.kbp = m.take<bf16>(d.bank_s * CA_PG);
  s.vbp = m.take<bf16>(d.bank_s * CA_PG);
  s.att = m.take<bf16>(M * CA_GW);
}

static AttnGeom cga256_geom(const Dims& d, const Cga256& s) {
  AttnGeom g{};
  g.q = s.qkv;
  g.k = s.qkv + CA_PG;
  g.v = s.qkv + 2 * CA_PG;
  g.ks = s.kbp;
  g.vs = s.vbp;
  g.ldq = g.ldk = CA_G * CA_QKV;
  g.ldks = CA_PG;
  g.ldo = CA_GW;
  g.gq = g.gk = CA_QKV;
  g.gks = 0;
  g.go = CA_PG;
  g.B = d.B;
  g.nq = g.nko = d.n;
  g.nks = d.bank_s;
  g.VH = CA_G * CA_H;
  g.H = CA_H;
  g.D = CA_PG / CA_H;
  return g;
}

static int cga256_attention(const CgaArgs& a, const bf16* wqkv,
                            const Cga256& s, int* bad, const int* flag,
                            void* stream) {
  const Dims& d = a.d;
  const int S = d.bank_s, M = d.B * d.n;
  QV_TRY(qv_map(CA_QKV, QkvBiasF{a.q_b, a.k_b, a.v_b, s.bias}, stream));
  QV_TRY(qv_map(S * CA_C, QvToBf16{a.bank_k, s.bank_r}, stream));
  QV_TRY(qv_map(S * CA_C, QvToBf16{a.bank_v, s.bank_r + S * CA_C}, stream));
  QV_TRY(qv_map(CA_C * CA_PG, QvToBf16{a.bk_w, s.bkw}, stream));
  QV_TRY(qv_map(CA_C * CA_PG, QvToBf16{a.bv_w, s.bvw}, stream));
  QV_TRY(qv_gemm(static_cast<const bf16*>(a.xn), CA_CPG, wqkv, CA_QKV,
                 M * CA_G, CA_QKV, CA_CPG, dense_epi(s.qkv, CA_QKV, s.bias),
                 stream));
  QV_TRY(qv_gemm(s.bank_r, CA_C, s.bkw, CA_PG, S, CA_PG, CA_C,
                 dense_epi(s.kbp, CA_PG, a.bk_b), stream));
  QV_TRY(qv_gemm(s.bank_r + S * CA_C, CA_C, s.bvw, CA_PG, S, CA_PG, CA_C,
                 dense_epi(s.vbp, CA_PG, a.bv_b), stream));
  AttnArgs at{cga256_geom(d, s), s.att, qv_drop(d, CGA_ATTN), d.guard, bad + 1};
  QV_TRY(qv_attn<4>(at, stream));
  return qv_map((long long)M * CA_GW, QvZeroIf{s.att, flag}, stream);
}

static size_t cga256_fwd_bytes(const Dims& d) {
  QvBump m{nullptr};
  Cga256 s;
  cga256_bufs(m, d, s);
  return m.used;
}

static int cga256_forward(const CgaArgs& a, const bf16* wqkv,
                          const bf16* wproj, void* scratch, bool train,
                          void* stream) {
  const Dims& d = a.d;
  QvBump m{static_cast<char*>(scratch)};
  Cga256 s;
  cga256_bufs(m, d, s);
  QV_TRY(cga256_attention(a, wqkv, s, a.ws, a.ws, stream));
  EpiDense e = dense_epi(static_cast<bf16*>(a.out), CA_C, a.proj_b);
  e.mk = row_masks(d, CGA_PROJ, CA_C);
  QV_TRY(qv_gemm(s.att, CA_GW, wproj, CA_C, d.B * d.n, CA_C, CA_GW, e,
                 stream));
  if (!train) return 0;
  return qv_bank256(static_cast<const bf16*>(a.out), a.bw, d, stream);
}

struct Cga256B {
  bf16 *dob, *dqkvb;
  float *datt, *dqkv, *dks, *dvs, *dkp, *dvp, *stats, *dxn;
  int* bad;
};

static void cga256_bwd_bufs(QvBump& m, const Dims& d, Cga256& s,
                            Cga256B& t) {
  const size_t M = (size_t)d.B * d.n, VH = CA_G * CA_H;
  cga256_bufs(m, d, s);
  t.dob = m.take<bf16>(M * CA_C);
  t.dqkvb = m.take<bf16>(M * CA_G * CA_QKV);
  t.datt = m.take<float>(M * CA_GW);
  t.dqkv = m.take<float>(M * CA_G * CA_QKV);
  t.dks = m.take<float>(d.B * VH * d.bank_s * (CA_PG / CA_H));
  t.dvs = m.take<float>(d.B * VH * d.bank_s * (CA_PG / CA_H));
  t.dkp = m.take<float>((size_t)d.grid * d.bank_s * CA_PG);
  t.dvp = m.take<float>((size_t)d.grid * d.bank_s * CA_PG);
  t.stats = m.take<float>(d.B * VH * d.n * 3);
  t.bad = m.take<int>(2);
}

static size_t cga256_bwd_bytes(const Dims& d) {
  QvBump m{nullptr};
  Cga256 s;
  Cga256B t;
  cga256_bwd_bufs(m, d, s, t);
  return m.used;
}

// w: bf16 W_qkv [32, 48], W_p [96, C], W_qkv^T [48, 32], W_p^T [C, 96]
static int cga256_backward(const CgaBwdArgs& a, const bf16* w, void* scratch,
                           void* stream) {
  const CgaArgs& f = a.f;
  const Dims& d = f.d;
  const CgaGrads& gr = a.g;
  const int P = d.grid, M = d.B * d.n, S = d.bank_s;
  const bf16* wqkv = w;
  const bf16* wqkv_t = w + CA_CPG * CA_QKV + CA_GW * CA_C;
  const bf16* wp_t = wqkv_t + CA_QKV * CA_CPG;
  float* gws = a.c.gws;
  const int ws = a.c.wstride;
  QvBump m{static_cast<char*>(scratch)};
  Cga256 s;
  Cga256B t;
  cga256_bwd_bufs(m, d, s, t);
  QV_TRY(cga256_attention(f, wqkv, s, t.bad, a.c.flag, stream));
  RowMasks mk = row_masks(d, CGA_PROJ, CA_C);
  QV_TRY(qv_map((long long)M * CA_C,
                QvDropBwd{static_cast<const bf16*>(a.d_out), t.dob, mk},
                stream));
  QV_TRY(qv_wgrad(s.att, CA_GW, t.dob, CA_C, M, CA_GW, CA_C, P, gws, ws,
                  gr.proj_w, CA_C, gr.proj_b, stream));
  QV_TRY(qv_gemm(t.dob, CA_C, wp_t, CA_GW, M, CA_GW, CA_C,
                 EpiF32{t.datt, CA_GW, 0, 0}, stream));
  AttnBwdArgs ab{cga256_geom(d, s), t.datt, t.dqkv, t.dqkv + CA_PG,
                 t.dqkv + 2 * CA_PG, t.dks, t.dvs, t.stats,
                 CA_G * CA_QKV, CA_G * CA_QKV, qv_drop(d, CGA_ATTN),
                 a.c.flag};
  QV_TRY(qv_attn_bwd<4>(ab, stream));
  // the bank keys: summed over the slice's samples and the groups, then
  // through the bank projections
  QV_TRY(qv_map(2LL * P * S * CA_PG, QvZero{t.dkp}, stream));
  const int VH = CA_G * CA_H, hd = CA_PG / CA_H;
  QV_TRY(qv_launch(shared_sum_kernel<>,
                   SharedSumArgs{t.dks, t.dkp, (size_t)S * CA_PG, d.B, VH,
                                 CA_H, hd, S, P},
                   0, stream, qv_grid(P)));
  QV_TRY(qv_launch(shared_sum_kernel<>,
                   SharedSumArgs{t.dvs, t.dvp, (size_t)S * CA_PG, d.B, VH,
                                 CA_H, hd, S, P},
                   0, stream, qv_grid(P)));
  QV_TRY(qv_launch(bank_proj_bwd_kernel<>,
                   BankProjBwdArgs{f.bank_k, f.bk_w, t.dkp, gws, ws,
                                   (int)(gr.bk_w - gws), (int)(gr.bk_b - gws),
                                   (int)(gr.bank_k - gws), S, CA_C, CA_PG, P},
                   0, stream, qv_grid(P)));
  QV_TRY(qv_launch(bank_proj_bwd_kernel<>,
                   BankProjBwdArgs{f.bank_v, f.bv_w, t.dvp, gws, ws,
                                   (int)(gr.bv_w - gws), (int)(gr.bv_b - gws),
                                   (int)(gr.bank_v - gws), S, CA_C, CA_PG, P},
                   0, stream, qv_grid(P)));
  // q | k | v over the groups' rows
  const int MG = M * CA_G;
  QV_TRY(qv_map((long long)MG * CA_QKV, QvToBf16{t.dqkv, t.dqkvb}, stream));
  const bf16* xg = static_cast<const bf16*>(f.xn);
  QV_TRY(qv_wgrad(xg, CA_CPG, t.dqkvb, CA_QKV, MG, CA_CPG, CA_PG, P, gws, ws,
                  gr.q_w, CA_PG, gr.q_b, stream, a.c.flag));
  QV_TRY(qv_wgrad(xg, CA_CPG, t.dqkvb + CA_PG, CA_QKV, MG, CA_CPG, CA_PG, P,
                  gws, ws, gr.k_w, CA_PG, gr.k_b, stream, a.c.flag));
  QV_TRY(qv_wgrad(xg, CA_CPG, t.dqkvb + 2 * CA_PG, CA_QKV, MG, CA_CPG, CA_PG,
                  P, gws, ws, gr.v_w, CA_PG, gr.v_b, stream, a.c.flag));
  QV_TRY(qv_gemm(t.dqkvb, CA_QKV, wqkv_t, CA_CPG, MG, CA_CPG, CA_QKV,
                 EpiBf16{static_cast<bf16*>(a.d_xn), CA_CPG, 0}, stream));
  return qv_reduce(gws, a.c.grad, P, ws, d.rgrid, stream);
}

}  // namespace qv

// bf16 at n = 256 (qv_n256): `a` as for qv_unit_cga, the packed q | k | v
// kernel [32, 48] and W_p [96, C] rounded to bf16, a scratch of
// qv_unit_cga_mma256_scratch(d) floats.  Eval; the train entry also
// writes the bank-write partials.
extern "C" int qv_unit_cga_mma256(const qv::CgaArgs* a, const void* wqkv,
                                  const void* wproj, void* scratch,
                                  int is_bf16, void* stream) {
  if (!is_bf16 || !qv_n256(a->d) || a->d.train) return qv::ERR_ARGS;
  return qv::cga256_forward(*a, static_cast<const qv::bf16*>(wqkv),
                            static_cast<const qv::bf16*>(wproj), scratch,
                            false, stream);
}

extern "C" int qv_unit_cga_mma_train256(const qv::CgaArgs* a,
                                        const void* wqkv, const void* wproj,
                                        void* scratch, int is_bf16,
                                        void* stream) {
  if (!is_bf16 || !qv_n256(a->d) || !a->d.train) return qv::ERR_ARGS;
  return qv::cga256_forward(*a, static_cast<const qv::bf16*>(wqkv),
                            static_cast<const qv::bf16*>(wproj), scratch,
                            true, stream);
}

extern "C" int qv_unit_cga_mma256_smem(const qv::Dims*) { return qv::GM_SMEM; }
extern "C" int qv_unit_cga_mma_train256_smem(const qv::Dims*) {
  return qv::BK_SMEM;
}
extern "C" int qv_unit_cga_mma256_scratch(const qv::Dims* d) {
  return (int)((qv::cga256_fwd_bytes(*d) + 3) / 4);
}
extern "C" int qv_unit_cga_mma_train256_scratch(const qv::Dims* d) {
  return (int)((qv::cga256_fwd_bytes(*d) + 3) / 4);
}

// the backward at n = 256: `a` as for qv_unit_cga_bwd with the bf16
// weights beside it (the packed q | k | v kernel, W_p, then both
// transposed) and a scratch of qv_unit_cga_bwd_mma256_scratch(d) floats
extern "C" int qv_unit_cga_bwd_mma256(const qv::CgaBwdArgs* a, const void* w,
                                      void* scratch, int is_bf16,
                                      void* stream) {
  if (!is_bf16 || !qv_n256(a->f.d)) return qv::ERR_ARGS;
  return qv::cga256_backward(*a, static_cast<const qv::bf16*>(w), scratch,
                             stream);
}
extern "C" int qv_unit_cga_bwd_mma256_smem(const qv::Dims*) {
  return qv::GM_SMEM;
}
extern "C" int qv_unit_cga_bwd_mma256_scratch(const qv::Dims* d) {
  return (int)((qv::cga256_bwd_bytes(*d) + 3) / 4);
}
