// Unit 1 of the fused block (norm1 + SWA branch), forward in training at
// n = 64 (hqavit_tiny_in / hqavit_proc_tin: an 8x8 grid in four 4x4
// windows) in bf16: swa_train64_kernel, the C entry
// qv_unit_swa_mma_train64.
//
// Replaces, with swa_mma_kernel (unit_swa.cu), the TPU unit
// qavit_tpu/kernels/fused_kernels.py make_cores.core_swa
// (fused_cores.py:672 swa_bd), run through fused_pallas.py:190-212
// fwd_call.
//
// Bound on the H100 at B=128: x, out, xn (3 MB) and the float32 weights
// (~3 us at 3.35 TB/s) against 2.9 GFLOP (~3 us at 989 TFLOP/s).  The
// single-block design (swa_mma_kernel<1, true>, a sample a block, one
// CTA of 8 warps an SM at B=128) ran a chain of three 64-row products of
// six ring slices each, the attention and the bank partials on one SM a
// sample (PERF.md section 6, its phases).  A sample's four windows are
// independent up to the bank partials, each window's kc | vc made from
// its own 16 rows: so a cluster of two CTAs takes a sample, CTA rank r
// its windows 2r and 2r + 1 (32 rows in the window-major order of
// window_mma.cuh's tiles), and repeats no product; 105,744 B a CTA, so
// that two CTAs, 16 warps, share an SM.  Only the bank partials cross
// the pair: the gate's softmax over the sample's 64 tokens through the
// pair's maxima and sums, part_v summed over the pair in rank order at
// the end (window_train64.cuh).  Every kept value of both dropouts is
// the product with 1 / keep (within an ulp of the quotient), part_k is
// formed once after the reduction (qv_bank_compress), every bf16
// rounding point of the plain version is kept.  Masks: the counter hash
// at each element's flat index in the [B nw, 16, ...] layout, the window
// 4 b + 2 r + w.  The batch-wide NaN guard: finish_guard_pair, the redo
// on the last cluster.  Time: PERF.md section 6 row 1 @n64 train.
#include "window_train64.cuh"

QV_STAMPS_DEFINE(swa_fwd,
                 "prologue,staging,norm1 and xn store,kv,q,kc|vc,attention,"
                 "proj and store,partials t and logits,partials store,guard,"
                 "partials exchange and sums")

namespace qv {

// a CTA's buffers, bf16 elements (leading dims as window_mma.cuh's)
constexpr int SW_BANK = 2 * SM_S * SM_LDX;            // bank k, v
constexpr int SW_ET = 2 * SM_LK * SM_LDE;             // E_k^T, E_v^T
constexpr int SW_XS = WT_ROWS * SM_LDX;               // x, then xn
constexpr int SW_KV = WT_ROWS * 2 * SM_LDX;           // k | v; the
                                                      // attention rows
constexpr int SW_KCVC = 2 * 2 * SM_LK * SM_LDX;       // kc, vc a window; the
                                                      // q and proj rings;
                                                      // the partials' scratch
static_assert(WT_ROWS * SM_LDKV <= SW_KV, "k | v");
static_assert(3 * RING_KS * SM_LDKV <= SW_KV + SW_KCVC &&
                  3 * RING_KS * SM_LDX <= SW_KCVC &&
                  2 * WT_SCRATCH <= SW_KCVC,
              "the rings and the partials' scratch");
constexpr int SW_SMEM_BYTES =
    2 * (SW_BANK + SW_ET + SW_XS + SW_KV + SW_KCVC) +
    4 * (WT_XCH + 4);                                 // the exchange, flags
static_assert(2 * SW_SMEM_BYTES <= 228 * 1024 - 2 * 1024, "two CTAs an SM");

// One two-CTA cluster a sample: CTA rank r its windows 2r, 2r + 1 (rows
// 16 w + i of its 32, token window_base(2r + w) + (i / 4) 8 + i % 4),
// each step on its own rows: norm1 (xn to device memory), kv = xn @ W_kv
// + b (32 rows x 384), then warp (window w, head h): q = xn @ W_q + b
// straight into A fragments; kc | vc = rnd(E^T @ k | v) per window; the
// window's 16 queries over its 32 compressed keys and the S bank keys,
// proj and its dropout, the rows to their tokens; the bank partials with
// the partner.  Every weight streams through a ring of three slices.
// While kc | vc, attention and proj run, cp.async brings the next
// sample's rows.
// The buffers:
//   xs    x, then xn
//   kv    k | v [32][SM_LDKV]; the attention rows, then proj's in place
//   kcvc  kc, vc of window w at (2 w, 2 w + 1) [SM_LK][SM_LDX]; before
//         them the q ring, after them the proj ring and the partials'
//         scratch (and the pair's sums)
//   kv and kcvc: the kv ring
__global__ void __launch_bounds__(NTHREADS, 2)
    swa_train64_kernel(SwaMmaArgs m) {
  QV_SMEM_DECL
  QV_STAMP(swa_fwd, -1);
  const SwaArgs& a = m.f;
  const Dims& d = a.d;
  const int S = d.bank_s, C = SM_C;
  const int rank = (int)cluster_rank();
  const int clusters = (int)gridDim.x / 2;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  bf16* bk = reinterpret_cast<bf16*>(qv_smem);
  bf16* bv = bk + SM_S * SM_LDX;
  bf16* et = bv + SM_S * SM_LDX;           // [2][SM_LK][SM_LDE]
  bf16* xs = et + SW_ET;
  bf16* kv = xs + SW_XS;
  bf16* att = kv;
  bf16* kcvc = kv + SW_KV;
  float* scratch = reinterpret_cast<float*>(kcvc);
  float* xch = reinterpret_cast<float*>(kcvc + SW_KCVC);
  int* flags = reinterpret_cast<int*>(xch + WT_XCH);
  const float inv_keep = 1.f / d.keep;
  if (threadIdx.x == 0) flags[2] = 0;      // NaN seen

  // the sample's token of the CTA's row r
  auto token = [&](int r) {
    const int i = r & (NT - 1);
    return window_base(d, 2 * rank + r / NT) + (i / WS) * SM_SIDE + i % WS;
  };
  // the CTA's rows from shared memory to sample b's tokens of dst
  auto store_rows = [&](void* dst, int b, const bf16* src) {
    bf16* o = static_cast<bf16*>(dst) + (size_t)b * SM_N * C;
    for (int i = threadIdx.x; i < WT_ROWS * (C / 8); i += blockDim.x) {
      const int r = i / (C / 8), c = (i - r * (C / 8)) * 8;
      *reinterpret_cast<uint4*>(o + token(r) * C + c) =
          *reinterpret_cast<const uint4*>(src + r * SM_LDX + c);
    }
  };
  auto stage_x = [&](int b) {
    const bf16* src = static_cast<const bf16*>(a.x) + (size_t)b * SM_N * C;
    for (int i = threadIdx.x; i < WT_ROWS * (C / 8); i += blockDim.x) {
      const int r = i / (C / 8), c = (i - r * (C / 8)) * 8;
      cp_async_16(xs + r * SM_LDX + c, src + token(r) * C + c);
    }
    cp_async_commit();
  };
  const int first = (int)blockIdx.x / 2;   // the cluster's first sample
  if (first < d.B) stage_x(first);
  __syncthreads();                         // flags[2] is clear

  // per CTA: the bank rows rounded (rows past S zero), E_k^T and E_v^T
  // rounded ([lin_k, 16] each), a float4 of E a thread
  if (stage_bank(a.bank_k, a.bank_v, S, bk, bv, SM_LDX) && d.guard)
    flags[2] = 1;                          // after the barrier above
  static_assert(2 * NT * SM_LK == 4 * NTHREADS, "a float4 of E a thread");
  {
    const int w = threadIdx.x / (NTHREADS / 2);
    const int r4 = 4 * (threadIdx.x % (NTHREADS / 2));
    const int k = r4 / SM_LK, mrow = r4 - k * SM_LK;
    put4(et + w * SM_LK * SM_LDE + mrow * SM_LDE + k, SM_LDE,
         reinterpret_cast<const float4*>(w ? a.e_v : a.e_k)[r4 / 4]);
  }
  QV_STAMP(swa_fwd, 0);

  BankSums sums;
  bank_sums_zero(sums);
  int parity = 0;                          // of the gate exchange
  // the warp's window (its 16 queries) and head in q, attention and proj
  const int mt = warp >> 2, hh = warp & 3;
  // proj's dense epilogue and dropout, sample b's CTA row r
  auto proj_out = [&](int b, int r, int col, float acc, float bias) {
    return rnd<bf16>(drop_r(
        d, SWA_PROJ,
        (unsigned)(((size_t)b * SM_N + WT_ROWS * rank + r) * C + col),
        dense_out(acc, bias), inv_keep));
  };
  // sample b's proj rows in att to its tokens, and its bank partials
  auto finish = [&](int b) {
    store_rows(a.out, b, att);
    QV_STAMP(swa_fwd, 7);
    bank_pair_partials(att, SM_LDX, a.bw, S, scratch, xch, parity, sums,
                       [] { QV_STAMP(swa_fwd, 8); });
    parity ^= 1;
    QV_STAMP(swa_fwd, 11);
  };

  for (int b = first; b < d.B; b += clusters) {
    cp_async_wait<0>();
    __syncthreads();
    QV_STAMP(swa_fwd, 1);
    ln_rows<WT_ROWS, SM_C>(xs, xs, SM_LDX, a.norm1_s, a.norm1_b);
    __syncthreads();
    store_rows(a.xn, b, xs);
    QV_STAMP(swa_fwd, 2);
    {  // kv = xn @ W_kv + b: warp w, columns 48 w.. of 384, the 32 rows;
       // W_kv streams through k | v's and kc | vc's space
      float acc[2][6][4];
      ring_gemm<2, 6, 3>(xs, SM_LDX, m.qkv_w16 + C, 3 * C, 2 * C, C, kv,
                         SM_LDKV, 48 * warp, acc);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < 6; ++j) {
          const int col = 48 * warp + 8 * j + 2 * t;
          const float b0 = a.qkv_b[C + col], b1 = a.qkv_b[C + col + 1];
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
            store_bf16x2(kv + (mi * 16 + g + 8 * hf) * SM_LDKV + col,
                         pack_bf16x2(dense_out(acc[mi][j][2 * hf], b0),
                                     dense_out(acc[mi][j][2 * hf + 1], b1)));
        }
    }
    __syncthreads();
    QV_STAMP(swa_fwd, 3);
    // q = xn @ W_q + b of head hh: warp (mt, hh) rows 16 mt.., columns
    // 48 hh..; W_q streams through kc | vc's space
    unsigned qa[3][4];
    {
      float acc[1][6][4];
      ring_gemm<1, 6, 3>(xs + mt * NT * SM_LDX, SM_LDX, m.qkv_w16, 3 * C, C,
                         C, kcvc, SM_LDX, 48 * hh, acc);
      if (q_head_fragments(acc, a.qkv_b, 48 * hh, qa) && d.guard)
        flags[2] = 1;
    }
    // xs is free: bring the next sample's rows while this one finishes
    if (b + clusters < d.B) stage_x(b + clusters);
    QV_STAMP(swa_fwd, 4);
    {  // kc | vc of window w = rnd(E^T @ k | v of its 16 rows): warp (w,
       // k or v, half the columns), 48 columns a step
      const int w = warp >> 2, kv_half = (warp >> 1) & 1;
      const int c1 = (C / 2) * (warp & 1);
      const bf16* ew = et + kv_half * SM_LK * SM_LDE;
      const bf16* src = kv + w * NT * SM_LDKV + kv_half * C;
      bf16* dst = kcvc + (2 * w + kv_half) * SM_LK * SM_LDX;
      unsigned af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        load_a(af[mi], ew + mi * 16 * SM_LDE, SM_LDE, lane);
      bool nan_seen = false;
#pragma unroll
      for (int c0 = c1; c0 < c1 + C / 2; c0 += 48) {
        float acc[2][6][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int j = 0; j < 6; ++j)
            acc[mi][j][0] = acc[mi][j][1] = acc[mi][j][2] = acc[mi][j][3] =
                0.f;
#pragma unroll
        for (int np = 0; np < 3; ++np) {
          unsigned kb[4];
          load_b_kn(kb, src + c0 + np * 16, SM_LDKV, lane);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            mma_bf16_16816(acc[mi][2 * np], af[mi], kb);
            mma_bf16_16816(acc[mi][2 * np + 1], af[mi], kb + 2);
          }
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int j = 0; j < 6; ++j)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const float x0 = acc[mi][j][2 * hf], x1 = acc[mi][j][2 * hf + 1];
              nan_seen = nan_seen || isnan(x0) || isnan(x1);
              store_bf16x2(dst + (mi * 16 + g + 8 * hf) * SM_LDX + c0 +
                               8 * j + 2 * t,
                           pack_bf16x2(x0, x1));
            }
      }
      if (d.guard && nan_seen) flags[2] = 1;
    }
    __syncthreads();
    QV_STAMP(swa_fwd, 5);
    {  // attention of window mt's 16 queries, head hh, over its 32
       // compressed keys and SM_S bank keys (past 32 + S: -inf); the
       // window is 4 b + 2 rank + mt of the [B nw] windows, whose mask
       // the dropout replays
      const bf16* kc = kcvc + 2 * mt * SM_LK * SM_LDX;
      const bf16* vc = kc + SM_LK * SM_LDX;
      const bf16* const kt[3] = {kc, kc + 16 * SM_LDX, bk};
      const bf16* const vt[3] = {vc, vc + 16 * SM_LDX, bv};
      const AttnMask am{attn_drop(d, SWA_ATTN),
                        (unsigned)(4 * b + 2 * rank + mt) * SM_H * NT *
                            (SM_LK + S),
                        hh, SM_LK + S};
      if (warp_attention_train<3, true>(qa, kt, vt, SM_LDX, hh * ATT_D,
                                        SM_LK + S, am, att + mt * NT * SM_LDX,
                                        SM_LDX) &&
          d.guard)
        flags[2] = 1;
    }
    __syncthreads();
    QV_STAMP(swa_fwd, 6);
    {  // proj = att @ W_p + b and its dropout: warp (mt, hh) rows 16 mt..,
       // columns 48 hh..; kc | vc are read, W_p streams through their
       // space; the rows replace att's
      float acc[1][6][4];
      ring_gemm<1, 6, 3>(att + mt * NT * SM_LDX, SM_LDX, m.proj_w16, C, C, C,
                         kcvc, SM_LDX, 48 * hh, acc);
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        const int col = 48 * hh + 8 * j + 2 * t;
        const float b0 = a.proj_b[col], b1 = a.proj_b[col + 1];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = mt * NT + g + 8 * hf;
          store_bf16x2(att + r * SM_LDX + col,
                       pack_bf16x2(proj_out(b, r, col, acc[0][j][2 * hf], b0),
                                   proj_out(b, r, col + 1,
                                            acc[0][j][2 * hf + 1], b1)));
        }
      }
    }
    __syncthreads();
    finish(b);
  }
  float* part = a.bw.part + (size_t)(blockIdx.x / 2) * 2 * S * C;
  bank_pair_store(sums, S, scratch, part);
  QV_STAMP(swa_fwd, 9);
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
          store_bf16x2(att + r * SM_LDX + col,
                       pack_bf16x2(proj_out(b, r, col, 0.f, a.proj_b[col]),
                                   proj_out(b, r, col + 1, 0.f,
                                            a.proj_b[col + 1])));
        }
        __syncthreads();
        finish(b);
      }
      bank_pair_store(sums, S, scratch, part);
      cluster_sync();
    });
  QV_STAMP(swa_fwd, 10);
}

}  // namespace qv

// The bf16 tensor-core kernel in training at n = 64 on an 8x8 grid in
// four windows (swa_train64_kernel): d.grid clusters of two CTAs, a
// sample a cluster at a time, each cluster's slice of the bank partials
// (part_v and the gate sums); then the reduction pass over the slices and
// the compression of their sum (qv_bank_compress).  `a` and the weights
// as for qv_unit_swa_mma; ERR_ARGS for any other geometry or type (the
// wrapper checks them first, swa_mma_error).  A cluster launch the card
// refuses returns its CUDA error.
extern "C" int qv_unit_swa_mma_train64(const qv::SwaArgs* a,
                                       const void* qkv_w16,
                                       const void* proj_w16, int is_bf16,
                                       void* stream) {
  const qv::Dims& d = a->d;
  if (!is_bf16 || !d.train || d.n != qv::SM_N || d.nw != qv::SM_NW ||
      d.side != qv::SM_SIDE || d.c != qv::SM_C || d.heads != qv::SM_H ||
      d.lin_k != qv::SM_LK || d.bank_s > qv::SM_S || d.grid > d.B)
    return qv::ERR_ARGS;
  const qv::SwaMmaArgs m{*a, static_cast<const qv::bf16*>(qkv_w16),
                         static_cast<const qv::bf16*>(proj_w16)};
  int rc = qv_launch_cluster(qv::swa_train64_kernel, m, qv::SW_SMEM_BYTES,
                             stream, d.grid, 2);
  if (rc == 0)
    rc = qv_reduce(a->bw.part, a->bw.part_out, d.grid, 2 * d.bank_s * d.c,
                   d.rgrid, stream);
  if (rc != 0) return rc;
  return qv_bank_compress(a->bw.part_out, a->bw.comp_w, a->bw.comp_b,
                          d.bank_s, stream);
}

extern "C" int qv_unit_swa_mma_train64_smem(const qv::Dims*) {
  return qv::SW_SMEM_BYTES;
}

// CTAs of swa_train64_kernel resident per SM and its two-CTA clusters
// resident at once on the card (0 on the host)
extern "C" int qv_unit_swa_mma_train64_occupancy(int* per_sm, int* clusters) {
  return qv_cluster_occupancy(qv::swa_train64_kernel, qv::SW_SMEM_BYTES, 2,
                              per_sm, clusters);
}
