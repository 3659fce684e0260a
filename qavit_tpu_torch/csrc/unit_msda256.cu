// Unit 2 of the fused block at n = 256 (qavit_v2_extreme_tin), forward
// (eval and train) and backward: the MSDA branch.
//
// Replaces the TPU kernels qavit_tpu/kernels/fused_pallas.py:190 fwd_call
// and :244 bwd_call for the core `msda` (fused_kernels.py:82) at 256
// tokens: pooling of 256 of the 320 dilated sites (stride 2) into 128
// rows, kv of the pooled rows, E[:128] -> 32 compressed keys plus the 16
// bank keys, the attention of all 256 queries, proj, dropout.
//
// The 32 compressed keys sum all 128 pooled rows of a sample, and each
// query attends to all of them, so the unit runs as a sequence of the
// n256_ops.cuh kernels on the caller's stream, its intermediates in the
// scratch buffer (bf16 at the plain version's rounding points):
//   pooled = rnd(sel xn)           map (the pooling lists of sel_t)
//   kv = dense(pooled; W_kv)       gemm_kernel
//   kc | vc = rnd(E^T k | v)       map, 128 terms an element
//   q = dense(xn; W_q)             gemm_kernel
//   att = attention(q; kc + bank)  attn_kernel<48> (guard: att zero)
//   out = dropout(dense(att; W_p)) gemm_kernel
// and in training the bank-write partials of out (bank256_kernel, the
// reduction, qv_bank_compress).  The backward recomputes the forward into
// its own scratch, then takes the VJP step by step: proj's (wgrad_kernel,
// gemm_kernel), the attention's (attn_bwd_*), the Linformer mix's (map;
// d(E) per slice), kv's and q's, the pooling's; each weight gradient over
// P = d.grid slices of the rows, summed by the reduction pass.
#include "n256_ops.cuh"

namespace qv {

constexpr int MS_C = 192, MS_LK = 32, MS_POOL = 8;

// per pooled row its terms (token, weight), and per token the pooled rows
// it feeds (row, weight), from sel_t [n, keep]
struct PoolLists {
  int* n_of;              // [keep]
  int* src;               // [keep][MS_POOL]
  float* w;               // [keep][MS_POOL]
  int* n_in;              // [n]
  int* dst;               // [n][MS_POOL]
  float* wi;              // [n][MS_POOL]
};

struct PoolListsF {
  PoolLists l;
  const float* sel_t;
  int n, keep;
  __device__ void operator()(int i) const {
    if (i < keep) {
      int cnt = 0;
      for (int t = 0; t < n; ++t) {
        const float v = sel_t[t * keep + i];
        if (v != 0.f && cnt < MS_POOL) {
          l.src[i * MS_POOL + cnt] = t;
          l.w[i * MS_POOL + cnt] = rnd<bf16>(v);
          ++cnt;
        }
      }
      l.n_of[i] = cnt;
    }
    if (i < n) {
      int cnt = 0;
      for (int p = 0; p < keep; ++p) {
        const float v = sel_t[i * keep + p];
        if (v != 0.f && cnt < MS_POOL) {
          l.dst[i * MS_POOL + cnt] = p;
          l.wi[i * MS_POOL + cnt] = rnd<bf16>(v);
          ++cnt;
        }
      }
      l.n_in[i] = cnt;
    }
  }
};

// pooled[b, p, c] = rnd(sum of the row's terms w xn[b, t, c])
struct PoolF {
  PoolLists l;
  const bf16* xn;
  bf16* pooled;
  int n, keep;
  __device__ void operator()(int i) const {
    const int c = (int)(i % MS_C);
    const int bp = i / MS_C;
    const int p = (int)(bp % keep), b = (int)(bp / keep);
    float acc = 0.f;
    for (int k = 0; k < l.n_of[p]; ++k)
      acc = fmaf(l.w[p * MS_POOL + k],
                 bf(xn + ((size_t)b * n + l.src[p * MS_POOL + k]) * MS_C + c),
                 acc);
    pooled[i] = from_f<bf16>(acc);
  }
};

// kc (w 0) | vc (w 1) [B, 32, C] = rnd(sum_p rnd(E_w[p, m]) kv[b, p, w C + c])
struct MixF {
  const bf16* kv;
  const float* e_k;
  const float* e_v;
  bf16* kc;
  bf16* vc;
  int keep, B;
  __device__ void operator()(int i) const {
    const int c = (int)(i % MS_C);
    int r = i / MS_C;
    const int m = (int)(r % MS_LK);
    r /= MS_LK;
    const int b = (int)(r % B), w = (int)(r / B);
    const float* e = w ? e_v : e_k;
    const bf16* src = kv + (size_t)b * keep * 2 * MS_C + w * MS_C + c;
    float acc = 0.f;
    for (int p = 0; p < keep; ++p)
      acc = fmaf(rnd<bf16>(e[p * MS_LK + m]), bf(src + (size_t)p * 2 * MS_C),
                 acc);
    (w ? vc : kc)[((size_t)b * MS_LK + m) * MS_C + c] = from_f<bf16>(acc);
  }
};

struct Msda256 {
  PoolLists l;
  bf16 *bank_r, *pooled, *kv, *kc, *vc, *q, *att;
};

static void msda256_bufs(QvBump& m, const Dims& d, Msda256& s) {
  const size_t M = (size_t)d.B * d.n, P = (size_t)d.B * d.msda_keep;
  s.l.n_of = m.take<int>(d.msda_keep);
  s.l.src = m.take<int>(d.msda_keep * MS_POOL);
  s.l.w = m.take<float>(d.msda_keep * MS_POOL);
  s.l.n_in = m.take<int>(d.n);
  s.l.dst = m.take<int>(d.n * MS_POOL);
  s.l.wi = m.take<float>(d.n * MS_POOL);
  s.bank_r = m.take<bf16>(2 * d.bank_s * MS_C);
  s.pooled = m.take<bf16>(P * MS_C);
  s.kv = m.take<bf16>(P * 2 * MS_C);
  s.kc = m.take<bf16>((size_t)d.B * MS_LK * MS_C);
  s.vc = m.take<bf16>((size_t)d.B * MS_LK * MS_C);
  s.q = m.take<bf16>(M * MS_C);
  s.att = m.take<bf16>(M * MS_C);
}

static AttnGeom msda256_geom(const Dims& d, const Msda256& s) {
  AttnGeom g{};
  g.q = s.q;
  g.k = s.kc;
  g.v = s.vc;
  g.ks = s.bank_r;
  g.vs = s.bank_r + d.bank_s * MS_C;
  g.ldq = g.ldk = g.ldks = g.ldo = MS_C;
  g.B = d.B;
  g.nq = d.n;
  g.nko = MS_LK;
  g.nks = d.bank_s;
  g.VH = g.H = d.heads;
  g.D = MS_C / d.heads;
  return g;
}

// the forward up to the attention output att (zero where `flag` says the
// guard tripped; the attention's own NaN check sets bad[1])
static int msda256_attention(const MsdaArgs& a, const bf16* wqkv,
                             const Msda256& s, int* bad, const int* flag,
                             void* stream) {
  const Dims& d = a.d;
  const int C = MS_C, keep = d.msda_keep;
  const long long M = (long long)d.B * d.n, P = (long long)d.B * keep;
  QV_TRY(qv_map(d.n > keep ? d.n : keep,
                PoolListsF{s.l, a.sel_t, d.n, keep}, stream));
  QV_TRY(qv_map(P * C, PoolF{s.l, static_cast<const bf16*>(a.xn), s.pooled,
                             d.n, keep},
                stream));
  QV_TRY(qv_map(d.bank_s * C, QvToBf16{a.bank_k, s.bank_r}, stream));
  QV_TRY(qv_map(d.bank_s * C, QvToBf16{a.bank_v, s.bank_r + d.bank_s * C},
                stream));
  QV_TRY(qv_gemm(s.pooled, C, wqkv + C, 3 * C, (int)P, 2 * C, C,
                 dense_epi(s.kv, 2 * C, a.qkv_b + C), stream));
  QV_TRY(qv_map(2LL * d.B * MS_LK * C,
                MixF{s.kv, a.e_k, a.e_v, s.kc, s.vc, keep, d.B}, stream));
  QV_TRY(qv_gemm(static_cast<const bf16*>(a.xn), C, wqkv, 3 * C, (int)M, C,
                 C, dense_epi(s.q, C, a.qkv_b), stream));
  AttnArgs at{msda256_geom(d, s), s.att, qv_drop(d, MSDA_ATTN), d.guard,
              bad + 1};
  QV_TRY(qv_attn<48>(at, stream));
  return qv_map(M * C, QvZeroIf{s.att, flag}, stream);
}

static size_t msda256_fwd_bytes(const Dims& d) {
  QvBump m{nullptr};
  Msda256 s;
  msda256_bufs(m, d, s);
  return m.used;
}

static int msda256_forward(const MsdaArgs& a, const bf16* wqkv,
                           const bf16* wproj, void* scratch, bool train,
                           void* stream) {
  const Dims& d = a.d;
  const int C = MS_C;
  QvBump m{static_cast<char*>(scratch)};
  Msda256 s;
  msda256_bufs(m, d, s);
  QV_TRY(msda256_attention(a, wqkv, s, a.ws, a.ws, stream));
  EpiDense e = dense_epi(static_cast<bf16*>(a.out), C, a.proj_b);
  e.mk = row_masks(d, MSDA_PROJ, C);
  QV_TRY(qv_gemm(s.att, C, wproj, C, d.B * d.n, C, C, e, stream));
  if (!train) return 0;
  return qv_bank256(static_cast<const bf16*>(a.out), a.bw, d, stream);
}

// The backward: the forward recomputed into the scratch (its guard from
// the forward's flag), then the VJP.  Gradient fields add into slice p <
// d.grid of c.gws; the reduction pass sums them into c.grad.
struct Msda256B {
  bf16 *dob, *dqb, *dkvb;
  float *datt, *dq, *dkc, *dvc, *dks, *dvs, *dpool, *dxn;
  int* bad;
};

static void msda256_bwd_bufs(QvBump& m, const Dims& d, Msda256& s,
                             Msda256B& t) {
  const size_t M = (size_t)d.B * d.n, P = (size_t)d.B * d.msda_keep;
  msda256_bufs(m, d, s);
  t.dob = m.take<bf16>(M * MS_C);
  t.dqb = m.take<bf16>(M * MS_C);
  t.dkvb = m.take<bf16>(P * 2 * MS_C);
  t.datt = m.take<float>(M * MS_C);
  t.dq = m.take<float>(M * MS_C);
  t.dkc = m.take<float>((size_t)d.B * MS_LK * MS_C);
  t.dvc = m.take<float>((size_t)d.B * MS_LK * MS_C);
  t.dks = m.take<float>((size_t)d.B * d.heads * d.bank_s * (MS_C / d.heads));
  t.dvs = m.take<float>((size_t)d.B * d.heads * d.bank_s * (MS_C / d.heads));
  t.dpool = m.take<float>(P * MS_C);
  t.dxn = m.take<float>(M * MS_C);
  t.bad = m.take<int>(2);
}

// d(k | v)[b, p, c] = sum_m rnd(E[p, m]) d(kc | vc)[b, m, c], as bf16
struct MixBwdF {
  const float* dkc;
  const float* dvc;
  const float* e_k;
  const float* e_v;
  bf16* dkv;
  int keep;
  __device__ void operator()(int i) const {
    const int wc = (int)(i % (2 * MS_C));
    const int bp = i / (2 * MS_C);
    const int p = (int)(bp % keep), b = (int)(bp / keep);
    const int w = wc / MS_C, c = wc - w * MS_C;
    const float* e = (w ? e_v : e_k) + p * MS_LK;
    const float* g = (w ? dvc : dkc) + (size_t)b * MS_LK * MS_C + c;
    float acc = 0.f;
    for (int m = 0; m < MS_LK; ++m)
      acc = fmaf(rnd<bf16>(e[m]), g[(size_t)m * MS_C], acc);
    dkv[i] = from_f<bf16>(acc);
  }
};

// d(E_w)[p, m] += sum over slice s's samples and the channels of
// k_w[b, p, c] d(kc_w)[b, m, c]: a block a (slice, w, p), thread (m, c
// lane of 8)
struct MixEArgs {
  const bf16* kv;
  const float* dkc;
  const float* dvc;
  float* gws;
  int wstride, off_k, off_v, keep, B, P;
  const int* flag;        // the forward's guard: nothing added where set
};

template <int = 0>
__global__ void __launch_bounds__(NTHREADS) mix_e_kernel(MixEArgs a) {
  if (a.flag[1]) return;
  const int m = threadIdx.x >> 3, cl = threadIdx.x & 7;
  for (int job = blockIdx.x; job < a.P * 2 * a.keep; job += gridDim.x) {
    const int s = job / (2 * a.keep), rest = job - s * 2 * a.keep;
    const int w = rest / a.keep, p = rest - w * a.keep;
    int lo, hi;
    split_rows(a.B, a.P, s, lo, hi);
    const float* g = w ? a.dvc : a.dkc;
    float acc = 0.f;
    for (int b = lo; b < hi; ++b) {
      const bf16* k = a.kv + ((size_t)b * a.keep + p) * 2 * MS_C + w * MS_C;
      const float* gm = g + ((size_t)b * MS_LK + m) * MS_C;
      for (int c = cl; c < MS_C; c += 8) acc = fmaf(bf(k + c), gm[c], acc);
    }
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (cl == 0)
      a.gws[(size_t)s * a.wstride + (w ? a.off_v : a.off_k) + p * MS_LK + m] +=
          acc;
  }
}

// d(xn) = the q path's dxn + the pooling's sel^T d(pooled), as bf16
struct PoolBwdF {
  PoolLists l;
  const float* dxn;
  const float* dpool;
  bf16* out;
  int n, keep;
  __device__ void operator()(int i) const {
    const int c = (int)(i % MS_C);
    const int bt = i / MS_C;
    const int t = (int)(bt % n), b = (int)(bt / n);
    float acc = dxn[i];
    for (int k = 0; k < l.n_in[t]; ++k)
      acc = fmaf(l.wi[t * MS_POOL + k],
                 dpool[((size_t)b * keep + l.dst[t * MS_POOL + k]) * MS_C + c],
                 acc);
    out[i] = from_f<bf16>(acc);
  }
};

static size_t msda256_bwd_bytes(const Dims& d) {
  QvBump m{nullptr};
  Msda256 s;
  Msda256B t;
  msda256_bwd_bufs(m, d, s, t);
  return m.used;
}

// w: bf16 W_qkv [C, 3C], W_p [C, C], W_qkv^T [3C, C], W_p^T [C, C]
static int msda256_backward(const MsdaBwdArgs& a, const bf16* w,
                            void* scratch, void* stream) {
  const MsdaArgs& f = a.f;
  const Dims& d = f.d;
  const MsdaGrads& gr = a.g;
  const int C = MS_C, keep = d.msda_keep, P = d.grid;
  const int M = d.B * d.n, MP = d.B * keep;
  const bf16* wqkv = w;
  const bf16* wqkv_t = w + 4 * C * C;
  const bf16* wp_t = wqkv_t + 3 * C * C;
  float* gws = a.c.gws;
  const int ws = a.c.wstride;
  QvBump m{static_cast<char*>(scratch)};
  Msda256 s;
  Msda256B t;
  msda256_bwd_bufs(m, d, s, t);
  QV_TRY(msda256_attention(f, wqkv, s, t.bad, a.c.flag, stream));
  // proj and its dropout
  RowMasks mk = row_masks(d, MSDA_PROJ, C);
  QV_TRY(qv_map((long long)M * C,
                QvDropBwd{static_cast<const bf16*>(a.d_out), t.dob, mk},
                stream));
  QV_TRY(qv_wgrad(s.att, C, t.dob, C, M, C, C, P, gws, ws, gr.proj_w, C,
                  gr.proj_b, stream));
  QV_TRY(qv_gemm(t.dob, C, wp_t, C, M, C, C, EpiF32{t.datt, C, 0, 0},
                 stream));
  // the attention
  AttnBwdArgs ab{msda256_geom(d, s), t.datt, t.dq, t.dkc, t.dvc, t.dks,
                 t.dvs, nullptr, C, C, qv_drop(d, MSDA_ATTN), a.c.flag};
  QV_TRY(qv_attn_bwd<48>(ab, stream));
  const int hd = C / d.heads;
  QV_TRY(qv_launch(shared_sum_kernel<>,
                   SharedSumArgs{t.dks, gr.bank_k, (size_t)ws, d.B, d.heads,
                                 d.heads, hd, d.bank_s, P},
                   0, stream, qv_grid(P)));
  QV_TRY(qv_launch(shared_sum_kernel<>,
                   SharedSumArgs{t.dvs, gr.bank_v, (size_t)ws, d.B, d.heads,
                                 d.heads, hd, d.bank_s, P},
                   0, stream, qv_grid(P)));
  // q
  QV_TRY(qv_map((long long)M * C, QvToBf16{t.dq, t.dqb}, stream));
  QV_TRY(qv_wgrad(static_cast<const bf16*>(f.xn), C, t.dqb, C, M, C, C, P,
                  gws, ws, gr.qkv_w, 3 * C, gr.qkv_b, stream, a.c.flag));
  QV_TRY(qv_gemm(t.dqb, C, wqkv_t, C, M, C, C, EpiF32{t.dxn, C, 0, 0},
                 stream));
  // the Linformer mix and kv
  QV_TRY(qv_map((long long)MP * 2 * C,
                MixBwdF{t.dkc, t.dvc, f.e_k, f.e_v, t.dkvb, keep}, stream));
  QV_TRY(qv_launch(mix_e_kernel<>,
                   MixEArgs{s.kv, t.dkc, t.dvc, gws, ws, (int)(gr.e_k - gws),
                            (int)(gr.e_v - gws), keep, d.B, P, a.c.flag},
                   0, stream, qv_grid(P * 2 * keep)));
  QV_TRY(qv_wgrad(s.pooled, C, t.dkvb, 2 * C, MP, C, 2 * C, P, gws, ws,
                  gr.qkv_w + C, 3 * C, gr.qkv_b + C, stream, a.c.flag));
  QV_TRY(qv_gemm(t.dkvb, 2 * C, wqkv_t + C * C, C, MP, C, 2 * C,
                 EpiF32{t.dpool, C, 0, 0}, stream));
  // the pooling, and d(xn)
  QV_TRY(qv_map((long long)M * C,
                PoolBwdF{s.l, t.dxn, t.dpool, static_cast<bf16*>(a.d_xn),
                         d.n, keep},
                stream));
  return qv_reduce(gws, a.c.grad, P, ws, d.rgrid, stream);
}

}  // namespace qv

// bf16 at n = 256 (qv_n256): `a` as for qv_unit_msda, W_qkv [C, 3C] and
// W_p [C, C] rounded to bf16, a scratch of qv_unit_msda_mma256_scratch(d)
// floats.  Eval; the train entry also writes the bank-write partials
// (d.grid slices of the samples in a->bw.part, their sum in part_out).
extern "C" int qv_unit_msda_mma256(const qv::MsdaArgs* a, const void* wqkv,
                                   const void* wproj, void* scratch,
                                   int is_bf16, void* stream) {
  if (!is_bf16 || !qv_n256(a->d) || a->d.train) return qv::ERR_ARGS;
  return qv::msda256_forward(*a, static_cast<const qv::bf16*>(wqkv),
                             static_cast<const qv::bf16*>(wproj), scratch,
                             false, stream);
}

extern "C" int qv_unit_msda_mma_train256(const qv::MsdaArgs* a,
                                         const void* wqkv, const void* wproj,
                                         void* scratch, int is_bf16,
                                         void* stream) {
  if (!is_bf16 || !qv_n256(a->d) || !a->d.train) return qv::ERR_ARGS;
  return qv::msda256_forward(*a, static_cast<const qv::bf16*>(wqkv),
                             static_cast<const qv::bf16*>(wproj), scratch,
                             true, stream);
}

extern "C" int qv_unit_msda_mma256_smem(const qv::Dims*) {
  return qv::GM_SMEM;
}
extern "C" int qv_unit_msda_mma_train256_smem(const qv::Dims*) {
  return qv::BK_SMEM;
}
extern "C" int qv_unit_msda_mma256_scratch(const qv::Dims* d) {
  return (int)((qv::msda256_fwd_bytes(*d) + 3) / 4);
}
extern "C" int qv_unit_msda_mma_train256_scratch(const qv::Dims* d) {
  return (int)((qv::msda256_fwd_bytes(*d) + 3) / 4);
}

// the backward at n = 256 (qv_n256): `a` as for qv_unit_msda_bwd with the
// bf16 weights beside it (W_qkv, W_p, then both transposed) and a scratch
// of qv_unit_msda_bwd_mma256_scratch(d) floats; d.grid slices of `gws`
// (zeroed by the caller), their sum into `grad`.
extern "C" int qv_unit_msda_bwd_mma256(const qv::MsdaBwdArgs* a,
                                       const void* w, void* scratch,
                                       int is_bf16, void* stream) {
  if (!is_bf16 || !qv_n256(a->f.d)) return qv::ERR_ARGS;
  return qv::msda256_backward(*a, static_cast<const qv::bf16*>(w), scratch,
                              stream);
}
extern "C" int qv_unit_msda_bwd_mma256_smem(const qv::Dims*) {
  return (2 * 256 * 48 + 3 * 256) * 4;     // attn_bwd_k_kernel<48>
}
extern "C" int qv_unit_msda_bwd_mma256_scratch(const qv::Dims* d) {
  return (int)((qv::msda256_bwd_bytes(*d) + 3) / 4);
}
