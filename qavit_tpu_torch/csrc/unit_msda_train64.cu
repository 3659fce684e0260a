// Unit 2 of the fused block (the MSDA branch), forward in training at
// n = 64 (hqavit_tiny_in / hqavit_proc_tin: 64 queries, 40 pooled rows)
// in bf16: msda_train64_kernel, the C entry qv_unit_msda_mma_train64.
//
// Replaces, with msda_mma_kernel and msda_mma16_kernel (unit_msda.cu),
// the TPU unit qavit_tpu/kernels/fused_kernels.py make_cores.core_msda
// (fused_cores.py:687 msda_bd), run through fused_pallas.py:190-212
// fwd_call.
//
// Bound on the H100 at B=128: xn and out (3 MB) and the float32 weights
// (~2 us at 3.35 TB/s) against 2.4 GFLOP (~2.5 us at 989 TFLOP/s).  The
// single-block design (msda_mma_kernel<true>, a sample a block, one CTA
// of 8 warps an SM at B=128) ran the pooling, the kv, q and proj products
// of six ring slices each, the attention and the bank partials as one
// chain on one SM a sample (PERF.md section 6, its phases).  Here a
// cluster of two CTAs takes a sample: both stage its 64 rows of xn and
// pool its msda_keep rows on the tensor cores (rnd(sel^T @ xn), the
// pooling matrix rounded to bf16, as msda_bwd_mma64_kernel recomputes
// them), then rank 0 forms k = pooled @ W_k + b and kc =
// rnd(E_k^T @ k), rank 1 v and vc, and each copies the other's 32 x 192
// block through distributed shared memory after a cluster barrier; each
// CTA then takes its own 32 queries (rows 32 r..) for q, the attention,
// proj and the bank partials, the gate's softmax with the partner
// (window_train64.cuh).  113,424 B a CTA, so that two CTAs share an SM.
// Every kept value of both dropouts is the product with 1 / keep (within
// an ulp of the quotient), part_k is formed once after the reduction
// (qv_bank_compress), every bf16 rounding point of the plain version is
// kept.  Masks: the counter hash at each element's flat index in the
// sample's [B, H, 64, kv] and [B, 64, C] layouts.  The batch-wide NaN
// guard: finish_guard_pair, the redo on the last cluster.  Time: PERF.md
// section 6 row 2 @n64 train.
#include "window_train64.cuh"

QV_STAMPS_DEFINE(msda_fwd,
                 "prologue,staging,pooling,kv,kc|vc and exchange,q,"
                 "attention,proj and store,partials t and logits,"
                 "partials store,guard,partials exchange and sums")

namespace qv {

constexpr int MT_KEEP = 48;             // pooled rows, padded to 3 m16 tiles
constexpr int MT_LDX = SM_LDX, MT_LDE = MT_KEEP + 8, MT_LDS = MT_KEEP + 8;
// a CTA's buffers, bf16 elements, then the gate exchange and the guard's
// flags (4-byte words)
constexpr int MT_BANK = 2 * SM_S * MT_LDX;       // bank k, v
constexpr int MT_ET = SM_LK * MT_LDE;            // this rank's E_k^T or E_v^T
constexpr int MT_XS = SM_N * MT_LDX;             // the sample's xn
constexpr int MT_POOLED = MT_KEEP * MT_LDX;      // the pooled rows
constexpr int MT_KCVC = 2 * SM_LK * MT_LDX;      // kc, vc
constexpr int MT_KVP = MT_KEEP * MT_LDX;         // their k or v; the
                                                 // attention rows
constexpr int MT_SEL = SM_N * MT_LDS;            // the pooling matrix
static_assert(3 * RING_KS * MT_LDX <= MT_KCVC + MT_KVP &&
                  3 * RING_KS * MT_LDX <= MT_POOLED + MT_KCVC &&
                  2 * RING_KS * MT_LDX <= MT_XS / 2 + MT_POOLED,
              "the kv, proj and q rings");
static_assert(2 * WT_SCRATCH <= MT_POOLED + MT_KCVC,
              "the partials' scratch before the attention rows");
constexpr int MT_SMEM_BYTES =
    2 * (MT_BANK + MT_ET + MT_XS + MT_POOLED + MT_KCVC + MT_KVP + MT_SEL) +
    4 * (WT_XCH + 4);
static_assert(2 * MT_SMEM_BYTES <= 228 * 1024 - 2 * 1024, "two CTAs an SM");

// One two-CTA cluster a sample, CTA rank r its queries 32 r.. .  The
// buffers:
//   xs      the sample's xn, all 64 rows (the pooling reads every token),
//           this rank's first: local row l is token l ^ 32 r; after
//           pooling the partner's half and pooled hold the q ring
//   pooled  the pooled rows [MT_KEEP][MT_LDX]
//   kc, vc  [SM_LK][MT_LDX]: this rank's (kc at rank 0, vc at rank 1),
//           then the partner's copied
//   kvp     the pooled rows' k (rank 0) or v (rank 1); the attention
//           rows, then proj's
//   sel     the pooling matrix sel_t [local row][MT_LDS], rounded
//   kc | vc and kvp: the kv ring; pooled and kc | vc: the proj ring and
//   the partials' scratch (and the pair's sums)
// The partner reads this rank's kc or vc from the cluster barrier after
// both are formed until its arrival after the copy; this CTA waits for
// that arrival before the proj ring rewrites them.
__global__ void __launch_bounds__(NTHREADS, 2)
    msda_train64_kernel(MsdaMmaArgs m) {
  QV_SMEM_DECL
  QV_STAMP(msda_fwd, -1);
  const MsdaArgs& a = m.f;
  const Dims& d = a.d;
  const int S = d.bank_s, keep = d.msda_keep, C = SM_C;
  const int rank = (int)cluster_rank();
  const int clusters = (int)gridDim.x / 2;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  bf16* bk = reinterpret_cast<bf16*>(qv_smem);
  bf16* bv = bk + SM_S * MT_LDX;
  bf16* et = bv + SM_S * MT_LDX;           // [SM_LK][MT_LDE]
  bf16* xs = et + MT_ET;
  bf16* pooled = xs + MT_XS;
  bf16* kc = pooled + MT_POOLED;
  bf16* vc = kc + SM_LK * MT_LDX;
  bf16* kvp = kc + MT_KCVC;
  bf16* att = kvp;
  bf16* sel = kvp + MT_KVP;
  bf16* own = rank ? vc : kc;              // this rank's half of kc | vc
  bf16* other = rank ? kc : vc;            // the partner's, copied
  float* xch = reinterpret_cast<float*>(sel + MT_SEL);
  int* flags = reinterpret_cast<int*>(xch + WT_XCH);
  float* scratch = reinterpret_cast<float*>(pooled);
  const float inv_keep = 1.f / d.keep;
  const int flip = WT_ROWS * rank;         // local row l is token l ^ flip
  if (threadIdx.x == 0) flags[2] = 0;      // NaN seen

  auto stage_xn = [&](int b) {
    const bf16* src = static_cast<const bf16*>(a.xn) + (size_t)b * SM_N * C;
    for (int i = threadIdx.x; i < SM_N * (C / 8); i += blockDim.x) {
      const int r = i / (C / 8), c = (i - r * (C / 8)) * 8;
      cp_async_16(xs + r * MT_LDX + c, src + (r ^ flip) * C + c);
    }
    cp_async_commit();
  };
  const int first = (int)blockIdx.x / 2;   // the cluster's first sample
  if (first < d.B) stage_xn(first);
  __syncthreads();                         // flags[2] is clear

  // per CTA: the bank rows rounded (rows past S zero), this rank's E^T
  // and the pooling matrix sel_t [n, keep] rounded (past msda_keep zero),
  // a thread's loads all in flight
  if (stage_bank(a.bank_k, a.bank_v, S, bk, bv, MT_LDX) && d.guard)
    flags[2] = 1;
  {
    const float4 zero4{0.f, 0.f, 0.f, 0.f};
    const float4* e4 = reinterpret_cast<const float4*>(rank ? a.e_v : a.e_k);
    constexpr int N4 = MT_KEEP * SM_LK / 4;
#pragma unroll
    for (int k4 = 0; k4 < (N4 + NTHREADS - 1) / NTHREADS; ++k4) {
      const int i = threadIdx.x + k4 * NTHREADS;
      const int k = 4 * i / SM_LK, mrow = 4 * i - k * SM_LK;
      if (i < N4)
        put4(et + mrow * MT_LDE + k, MT_LDE, k < keep ? e4[i] : zero4);
    }
    constexpr int NS = SM_N * MT_KEEP / NTHREADS;
    static_assert(NS * NTHREADS == SM_N * MT_KEEP, "whole rounds");
    float v[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      const int i = threadIdx.x + k * NTHREADS;
      const int n = i / MT_KEEP, p = i - n * MT_KEEP;
      v[k] = p < keep ? a.sel_t[n * keep + p] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      const int i = threadIdx.x + k * NTHREADS;
      const int n = i / MT_KEEP, p = i - n * MT_KEEP;
      sel[(n ^ flip) * MT_LDS + p] = from_f<bf16>(rnd<bf16>(v[k]));
    }
  }
  QV_STAMP(msda_fwd, 0);

  BankSums sums;
  bank_sums_zero(sums);
  int parity = 0;                          // of the gate exchange
  // the warp's 16 queries (rows 32 rank + 16 mt) and head in q,
  // attention and proj
  const int mt = warp >> 2, hh = warp & 3;
  const int q0 = WT_ROWS * rank + NT * mt;
  // proj's dense epilogue and dropout (sample b, the CTA's row r), to
  // device memory and to att for the partials
  auto proj_put = [&](int b, int r, int col, float v0, float v1) {
    const size_t row = (size_t)b * SM_N + WT_ROWS * rank + r;
    auto out = [&](int c, float v) {
      return rnd<bf16>(drop_r(d, MSDA_PROJ, (unsigned)(row * C + c),
                              dense_out(v, a.proj_b[c]), inv_keep));
    };
    const unsigned u = pack_bf16x2(out(col, v0), out(col + 1, v1));
    store_bf16x2(static_cast<bf16*>(a.out) + row * C + col, u);
    store_bf16x2(att + r * MT_LDX + col, u);
  };
  auto partials = [&] {
    bank_pair_partials(att, MT_LDX, a.bw, S, scratch, xch, parity, sums,
                       [] { QV_STAMP(msda_fwd, 8); });
    parity ^= 1;
  };

  for (int b = first; b < d.B; b += clusters) {
    cp_async_wait<0>();
    __syncthreads();
    QV_STAMP(msda_fwd, 1);
    // pooled = rnd(sel^T @ xn) over the sample's 64 rows: warp w the
    // 16-column tiles w, w + 8, all three 16-row tiles (rows past keep
    // zero)
    for (int nt = warp; nt < C / 16; nt += NTHREADS / 32) {
      float acc[3][2][4];
#pragma unroll
      for (int mi = 0; mi < 3; ++mi)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          acc[mi][j][0] = acc[mi][j][1] = acc[mi][j][2] = acc[mi][j][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < SM_N / 16; ++ks) {
        unsigned bf[4];
        load_b_kn(bf, xs + 16 * ks * MT_LDX + 16 * nt, MT_LDX, lane);
#pragma unroll
        for (int mi = 0; mi < 3; ++mi) {
          unsigned af[4];
          load_a_t(af, sel + 16 * ks * MT_LDS + 16 * mi, MT_LDS, lane);
          mma_bf16_16816(acc[mi][0], af, bf);
          mma_bf16_16816(acc[mi][1], af, bf + 2);
        }
      }
#pragma unroll
      for (int mi = 0; mi < 3; ++mi)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
            store_bf16x2(pooled + (16 * mi + g + 8 * hf) * MT_LDX + 16 * nt +
                             8 * j + 2 * t,
                         pack_bf16x2(acc[mi][j][2 * hf],
                                     acc[mi][j][2 * hf + 1]));
    }
    __syncthreads();
    QV_STAMP(msda_fwd, 2);
    // this rank's k or v of the pooled rows (48 x 192), W_k or W_v
    // streamed through kc | vc's and kvp's space
    gemm_pass48<3>(pooled, MT_LDX, m.qkv_w16 + (1 + rank) * C, 3 * C, C, kc,
                   [&](int r, int c, float v0, float v1) {
                     const float* bias = a.qkv_b + (1 + rank) * C;
                     store_bf16x2(kvp + r * MT_LDX + c,
                                  pack_bf16x2(dense_out(v0, bias[c]),
                                              dense_out(v1, bias[c + 1])));
                   });
    __syncthreads();
    QV_STAMP(msda_fwd, 3);
    {  // this rank's kc or vc = rnd(E^T @ k | v): warp (16 rows from 16
       // (w & 1), 48 columns from 48 (w >> 1))
      const int mi = warp & 1, c0 = 48 * (warp >> 1);
      float acc[6][4];
#pragma unroll
      for (int j = 0; j < 6; ++j)
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < MT_KEEP / 16; ++kk) {
        unsigned af[4];
        load_a(af, et + mi * 16 * MT_LDE + kk * 16, MT_LDE, lane);
#pragma unroll
        for (int np = 0; np < 3; ++np) {
          unsigned kb[4];
          load_b_kn(kb, kvp + kk * 16 * MT_LDX + c0 + np * 16, MT_LDX, lane);
          mma_bf16_16816(acc[2 * np], af, kb);
          mma_bf16_16816(acc[2 * np + 1], af, kb + 2);
        }
      }
      bool nan_seen = false;
#pragma unroll
      for (int j = 0; j < 6; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float x0 = acc[j][2 * hf], x1 = acc[j][2 * hf + 1];
          nan_seen = nan_seen || isnan(x0) || isnan(x1);
          store_bf16x2(own + (mi * 16 + g + 8 * hf) * MT_LDX + c0 + 8 * j +
                           2 * t,
                       pack_bf16x2(x0, x1));
        }
      if (d.guard && nan_seen) flags[2] = 1;
    }
    cluster_sync();        // both halves of kc | vc are written
    {  // the partner's half into this CTA's
      const bf16* peer = cluster_peer(other, (unsigned)rank ^ 1u);
      for (int i = threadIdx.x; i < SM_LK * (C / 8); i += blockDim.x) {
        const int r = i / (C / 8), c = (i - r * (C / 8)) * 8;
        *reinterpret_cast<uint4*>(other + r * MT_LDX + c) =
            *reinterpret_cast<const uint4*>(peer + r * MT_LDX + c);
      }
    }
    cluster_arrive();      // this CTA's reads of the partner are done
    __syncthreads();
    QV_STAMP(msda_fwd, 4);
    // q = xn @ W_q + b of head hh: warp (mt, hh) rows q0.. (local rows
    // 16 mt..), columns 48 hh..; W_q streams through the space of the
    // partner's rows and pooled
    unsigned qa[3][4];
    {
      float acc[1][6][4];
      ring_gemm<1, 6, 2>(xs + NT * mt * MT_LDX, MT_LDX, m.qkv_w16, 3 * C, C,
                         C, xs + WT_ROWS * MT_LDX, MT_LDX, 48 * hh, acc);
      if (q_head_fragments(acc, a.qkv_b, 48 * hh, qa) && d.guard)
        flags[2] = 1;
    }
    // xs is free: bring the next sample's xn while this one finishes
    if (b + clusters < d.B) stage_xn(b + clusters);
    QV_STAMP(msda_fwd, 5);
    {  // attention of the warp's 16 queries, head hh, over 32 compressed
       // keys and SM_S bank keys (past 32 + S: -inf); the sample's mask
       // [H, 64, kv], the warp's rows from q0
      const bf16* const kt[3] = {kc, kc + 16 * MT_LDX, bk};
      const bf16* const vt[3] = {vc, vc + 16 * MT_LDX, bv};
      const AttnMask am{attn_drop(d, MSDA_ATTN),
                        (unsigned)(b * SM_H * SM_N + q0) * (SM_LK + S), hh,
                        SM_LK + S, SM_N};
      if (warp_attention_train<3, true>(qa, kt, vt, MT_LDX, hh * ATT_D,
                                        SM_LK + S, am, att + mt * NT * MT_LDX,
                                        MT_LDX) &&
          d.guard)
        flags[2] = 1;
    }
    __syncthreads();
    cluster_wait();        // the partner has read this rank's half
    QV_STAMP(msda_fwd, 6);
    {  // proj = att @ W_p + b and its dropout: warp (mt, hh) rows 16 mt..,
       // columns 48 hh..; W_p streams through pooled's and kc | vc's
       // space; the rows to device memory and in place of att's
      float acc[1][6][4];
      ring_gemm<1, 6, 3>(att + mt * NT * MT_LDX, MT_LDX, m.proj_w16, C, C, C,
                         pooled, MT_LDX, 48 * hh, acc);
#pragma unroll
      for (int j = 0; j < 6; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          proj_put(b, mt * NT + g + 8 * hf, 48 * hh + 8 * j + 2 * t,
                   acc[0][j][2 * hf], acc[0][j][2 * hf + 1]);
    }
    __syncthreads();
    QV_STAMP(msda_fwd, 7);
    partials();
    QV_STAMP(msda_fwd, 11);
  }
  float* part = a.bw.part + (size_t)(blockIdx.x / 2) * 2 * S * C;
  bank_pair_store(sums, S, scratch, part);
  QV_STAMP(msda_fwd, 9);
  if (!d.guard)
    cluster_sync();        // the partner has read this CTA's sums
  else
    finish_guard_pair(a.ws, flags[2], flags, [&] {
      // the redo: a zero attention output, so every row of every sample
      // is proj(0) = rnd(rnd(0) + rnd(bias)) through the proj dropout;
      // this cluster's partials sum the whole batch's, every other
      // cluster's slice zero
      zero_other_slices(a.bw.part, d.grid, S);
      bank_sums_zero(sums);
      for (int b = 0; b < d.B; ++b) {
        for (int i = threadIdx.x; i < WT_ROWS * C / 2; i += blockDim.x) {
          const int r = 2 * i / C, col = 2 * i - r * C;
          proj_put(b, r, col, 0.f, 0.f);
        }
        __syncthreads();
        partials();
      }
      bank_pair_store(sums, S, scratch, part);
      cluster_sync();
    });
  QV_STAMP(msda_fwd, 10);
}

}  // namespace qv

// The bf16 tensor-core kernel in training at n = 64 (msda_train64_kernel):
// d.grid clusters of two CTAs, a sample a cluster at a time, each
// cluster's slice of the bank partials (part_v and the gate sums); then
// the reduction pass over the slices and the compression of their sum
// (qv_bank_compress).  `a` and the weights as for qv_unit_msda_mma;
// ERR_ARGS for any other geometry or type (the wrapper checks them first,
// msda_mma_error).  A cluster launch the card refuses returns its CUDA
// error.
extern "C" int qv_unit_msda_mma_train64(const qv::MsdaArgs* a,
                                        const void* qkv_w16,
                                        const void* proj_w16, int is_bf16,
                                        void* stream) {
  const qv::Dims& d = a->d;
  if (!is_bf16 || !d.train || d.n != qv::SM_N || d.nw != qv::SM_NW ||
      d.msda_keep > qv::MT_KEEP || d.c != qv::SM_C || d.heads != qv::SM_H ||
      d.lin_k != qv::SM_LK || d.bank_s > qv::SM_S || d.grid > d.B)
    return qv::ERR_ARGS;
  const qv::MsdaMmaArgs m{*a, static_cast<const qv::bf16*>(qkv_w16),
                          static_cast<const qv::bf16*>(proj_w16)};
  int rc = qv_launch_cluster(qv::msda_train64_kernel, m, qv::MT_SMEM_BYTES,
                             stream, d.grid, 2);
  if (rc == 0)
    rc = qv_reduce(a->bw.part, a->bw.part_out, d.grid, 2 * d.bank_s * d.c,
                   d.rgrid, stream);
  if (rc != 0) return rc;
  return qv_bank_compress(a->bw.part_out, a->bw.comp_w, a->bw.comp_b,
                          d.bank_s, stream);
}

extern "C" int qv_unit_msda_mma_train64_smem(const qv::Dims*) {
  return qv::MT_SMEM_BYTES;
}

// CTAs of msda_train64_kernel resident per SM and its two-CTA clusters
// resident at once on the card (0 on the host)
extern "C" int qv_unit_msda_mma_train64_occupancy(int* per_sm,
                                                  int* clusters) {
  return qv_cluster_occupancy(qv::msda_train64_kernel, qv::MT_SMEM_BYTES, 2,
                              per_sm, clusters);
}
