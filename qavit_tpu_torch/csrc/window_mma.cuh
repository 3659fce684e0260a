// The bf16 tensor-core forward of the SWA and MSDA units, shared by
// swa_mma_kernel (unit_swa.cu) and msda_mma16_kernel (unit_msda.cu).
//
// Both units attend from 16 queries to a window's 32 Linformer-compressed
// keys plus the bank's, so they share one layout over tiles of 64 rows:
// four windows of 16 rows, each an m16 tile, with its own kc | vc.  A tile
// is one sample of n = 64 in its four 4x4 windows (SWA at hqavit_tiny_in's
// geometry, NS = 1: the window gather and scatter are row indexing), or
// four samples of n = 16, one window each (SWA and MSDA at hqavit_c100's,
// NS = 4: a sample's rows are contiguous, and a short last tile, B not a
// multiple of 4, loads and stores only its own samples' rows).  Per tile:
//   SWA   x -> norm1 (xn, also to device memory) -> kv = xn @ W_kv + b
//   MSDA  xn -> the pooled rows (each sample's msda_keep rows, from row
//         16 s, each the sum of its sel_t non-zeros in token order, as
//         token_mix sums them; rows past keep zero) -> kv = pooled @ W_kv
// then, for both, over all 64 rows with W_kv streamed once a tile through
// a three-buffer cp.async ring; kc | vc = rnd(E^T @ k | v) per window
// (E^T zero past the window's inputs: MSDA's pooled rows past keep are
// bias rows, which meet zeros); each warp then takes one window's 16
// queries x 2 heads: q through the ring straight into A fragments, the
// 48 scores a head in registers, softmax, rnd(P) V (warp_attention); proj
// through the ring; the rows to device memory as 16-byte copies.  Each
// ring lives in space that its product's step no longer needs (kv's and
// proj's in kc | vc's, q's in kv's; MSDA's pooled rows sit past the kv
// ring in kc | vc's space).  While attention and proj run, cp.async
// brings the next tile's rows.  The batch-wide NaN guard is kept: q, kc,
// vc, the bank and the attention output are checked, and the redo writes
// proj(0) (through the proj dropout in training) to every sample.
//
// Training is a compile-time property of its own instance (TRAIN), so
// the eval instances carry no mask: the attention-probability and proj
// dropout masks are the counter hash at each element's flat index in the
// JAX layout of its own window ([B nw, 16, ...]: the tile and the warp
// give the window, 4 tl + win at either NS, never a tile-local row), the
// attention's replayed by warp_attention_train as in the backward
// kernels; the bank-write partials of each tile's samples (mma_ops.cuh
// bank_tile_partials, float32 FMAs in kc | vc's space once proj is done;
// at n = 64 the gate's softmax runs over the sample's 64 tokens, which
// the window-major rows of a tile hold in another order that its sums
// do not see) are kept per thread over the block's tiles, and the
// block's slice is stored once at the end, for the reduction pass to
// sum.  Both train at n = 16 (swa_mma_kernel<4, true>,
// msda_mma16_kernel<true>): at n = 64 training is swa_train64_kernel and
// msda_train64_kernel's, on two-CTA clusters (unit_swa_train64.cu,
// unit_msda_train64.cu), and <1, true> at SIDE 8 is not instantiated.
//
// SIDE 16 (NS = 1; SWA at n = 256, qavit_v2_extreme_tin, unit_swa256.cu):
// a tile is a quarter of a sample, four grid rows, whose 16 tokens a
// window are its four 4x4 windows 4 (tl % 4) .. 4 (tl % 4) + 3, so the
// window of warp row `win` is still 4 tl + win of the [B nw] windows and
// row r of a tile still row 64 tl + r of their [B nw 16] rows: the masks
// and the per-window work are the n = 64 instance's.  In training the
// gate's softmax spans the sample's four tiles, so the bank-write partials
// are not formed here but by a pass over the output (bank256_kernel in
// n256_ops.cuh).
#pragma once
#include "mma_ops.cuh"

namespace qv {

struct SwaMmaArgs {
  SwaArgs f;              // the unit's arguments (f.qkv_w, f.proj_w unread)
  const bf16* qkv_w16;    // [C, 3C] qkv_w rounded to bf16
  const bf16* proj_w16;   // [C, C]
};

struct MsdaMmaArgs {
  MsdaArgs f;             // the unit's arguments (f.qkv_w, f.proj_w unread)
  const bf16* qkv_w16;    // [C, 3C] qkv_w rounded to bf16
  const bf16* proj_w16;   // [C, C]
};

// the geometry the kernels are written for (fused_kernels.swa_mma_error,
// msda_mma_error)
constexpr int SM_N = 64, SM_C = 192, SM_H = 4, SM_NW = 4, SM_SIDE = 8;
constexpr int SM_LK = 32;               // compressed keys of a window
constexpr int SM_S = 16;                // bank rows, at most
constexpr int SM_POOL = 8;              // terms of an MSDA pooled row, at most
static_assert(SM_C / SM_H == ATT_D, "warp_attention's head width");
static_assert(SM_C == BP_C && SM_S == BP_S && SM_N == BP_ROWS,
              "the bank partials' widths");
// leading dims: 8 bf16 past the width, so that the 8 rows one ldmatrix
// reads start in distinct banks
constexpr int SM_LDX = SM_C + 8, SM_LDKV = 2 * SM_C + 8, SM_LDE = NT + 8;
// shared memory, in bf16 elements
constexpr int SM_BANK = 2 * SM_S * SM_LDX;           // bank k, v
constexpr int SM_ET = 2 * SM_LK * SM_LDE;            // E_k^T, E_v^T
constexpr int SM_XS = SM_N * SM_LDX;                 // x, then xn
constexpr int SM_KV = SM_N * SM_LDKV;                // k | v; the q ring;
                                                     // the attention rows
constexpr int SM_KCVC = SM_NW * 2 * SM_LK * SM_LDX;  // kc, vc per window;
                                                     // the kv, proj rings
constexpr int SM_STAGES = 3;                         // ring buffers
constexpr int SM_RING_KV = SM_STAGES * RING_KS * SM_LDKV;
static_assert(SM_RING_KV + SM_N * SM_LDX <= SM_KCVC,
              "the kv ring and MSDA's pooled rows");
static_assert(SM_STAGES * RING_KS * SM_LDX <= SM_KV, "the q ring");
static_assert(2 * BP_SCRATCH <= SM_KCVC, "the bank partials' scratch");
constexpr int SM_SMEM_BYTES = 2 * (SM_BANK + SM_ET + SM_XS + SM_KV + SM_KCVC);
// MSDA: its pooling lists after the bf16 buffers (4-byte words)
constexpr int SM_MSDA_BYTES = SM_SMEM_BYTES + NT * (1 + 2 * SM_POOL) * 4;

enum WindowUnit { WIN_SWA, WIN_MSDA };

// The kernel body: UNIT the unit, NS the samples of a tile (1: n = 64, 4:
// n = 16), TRAIN the training instance; M is SwaMmaArgs or MsdaMmaArgs.
// It declares the dynamic shared memory itself: reached through a pointer
// argument, its buffers took generic addresses (191 registers for the
// n = 64 instance against 177).
template <int UNIT, int NS, bool TRAIN, typename M, int SIDE = SM_SIDE>
__device__ __forceinline__ void window_mma(const M& m) {
  constexpr bool MSDA = UNIT == WIN_MSDA;
  constexpr int SN = SM_N / NS;            // rows of a sample
  static_assert(NS == 1 || NS == 4, "one sample of 64 or four of 16");
  static_assert(!MSDA || NS == 4, "MSDA at n = 64 is msda_mma_kernel");
  static_assert(NS == 4 || !TRAIN || SIDE == 16,
                "n = 64 trains in swa_train64_kernel");
  static_assert(SIDE == SM_SIDE || (SIDE == 16 && NS == 1 && !MSDA),
                "SWA at n = 256 over quarter-sample tiles");
  constexpr int TPS = SIDE * SIDE / SM_N;   // tiles a sample
  // the bank-write partials: formed here at n = 16 only
  constexpr bool PARTS = TRAIN && NS == 4;
  constexpr int ATTN_KEY = MSDA ? MSDA_ATTN : SWA_ATTN;
  constexpr int PROJ_KEY = MSDA ? MSDA_PROJ : SWA_PROJ;
  QV_SMEM_DECL
  __shared__ int bad;
  const auto& a = m.f;
  const Dims& d = a.d;
  const int S = d.bank_s, C = SM_C;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  bf16* bk = reinterpret_cast<bf16*>(qv_smem);
  bf16* bv = bk + SM_S * SM_LDX;
  bf16* et = bv + SM_S * SM_LDX;           // [2][SM_LK][SM_LDE]
  bf16* xs = et + SM_ET;                   // [SM_N][SM_LDX]
  bf16* kv = xs + SM_XS;                   // [SM_N][SM_LDKV]
  bf16* att = kv;                          // [SM_N][SM_LDX], after kc | vc
  bf16* kcvc = kv + SM_KV;                 // [SM_NW][2][SM_LK][SM_LDX]
  // MSDA: the pooled rows [SM_N][SM_LDX] past the kv ring, and the
  // pooling lists of a sample's rows
  bf16* pooled = kcvc + SM_RING_KV;
  int* pool_n = reinterpret_cast<int*>(kcvc + SM_KCVC);
  int* pool_src = pool_n + NT;             // [NT][SM_POOL]
  float* pool_w = reinterpret_cast<float*>(pool_src + NT * SM_POOL);
  // training: the bank partials' scratch, once proj is done
  float* scratch = reinterpret_cast<float*>(kcvc);
  // the Linformer inputs of a window: its 16 rows, or MSDA's keep
  int keep = NT;
  if constexpr (MSDA) keep = d.msda_keep;
  // the rows a tile starts from (read where used, as a parameter)
  auto input = [&]() -> const void* {
    if constexpr (MSDA)
      return a.xn;
    else
      return a.x;
  };
  const bf16 zero = from_f<bf16>(0.f);

  if (threadIdx.x == 0) bad = 0;
  __syncthreads();
  // per block: the bank rows rounded (rows past S zero), E_k^T and E_v^T
  // rounded ([lin_k, 16] each, columns past keep zero); MSDA's pooling
  // lists, read off sel_t [16, keep]
  for (int i = threadIdx.x; i < SM_S * C; i += blockDim.x) {
    const int r = i / C, c = i - r * C;
    const float vk = r < S ? rnd<bf16>(a.bank_k[r * C + c]) : 0.f;
    const float vv = r < S ? rnd<bf16>(a.bank_v[r * C + c]) : 0.f;
    if (d.guard && (isnan(vk) || isnan(vv))) bad = 1;
    bk[r * SM_LDX + c] = from_f<bf16>(vk);
    bv[r * SM_LDX + c] = from_f<bf16>(vv);
  }
  for (int i = threadIdx.x; i < 2 * SM_LK * NT; i += blockDim.x) {
    const int w = i / (SM_LK * NT), r = i - w * SM_LK * NT;
    const int mrow = r / NT, k = r - mrow * NT;
    const float* e = w ? a.e_v : a.e_k;
    et[w * SM_LK * SM_LDE + mrow * SM_LDE + k] =
        !MSDA || k < keep ? from_f<bf16>(rnd<bf16>(e[k * SM_LK + mrow]))
                          : zero;
  }
  if constexpr (MSDA) {
    if ((int)threadIdx.x < keep) {
      const int r = threadIdx.x;
      int cnt = 0;
      for (int n = 0; n < NT; ++n) {
        const float w = a.sel_t[n * keep + r];
        if (w != 0.f && cnt < SM_POOL) {
          pool_src[r * SM_POOL + cnt] = n;
          pool_w[r * SM_POOL + cnt] = rnd<bf16>(w);
          ++cnt;
        }
      }
      pool_n[r] = cnt;
    }
  }

  const int tiles = NS == 1 ? d.B * TPS : (d.B * SN + SM_N - 1) / SM_N;
  // the rows of tile tl that hold samples
  auto valid_rows = [&](int tl) {
    if constexpr (NS == 1) return SM_N;
    const int v = d.B * SN - tl * SM_N;
    return v < SM_N ? v : SM_N;
  };
  // the token of tile tl's row r in its sample (its window 4 (tl % TPS)
  // + r / 16 of the sample's), and the sample's first row of tile tl
  auto token = [&](int tl, int r) {
    if constexpr (NS == 1) {
      const int i = r & (NT - 1);
      return window_base(d, (tl % TPS) * SM_NW + r / NT) + (i / WS) * SIDE +
             i % WS;
    }
    return r;
  };
  auto sample_row = [&](int tl) {
    return NS == 1 ? (size_t)(tl / TPS) * TPS * SM_N : (size_t)tl * SM_N;
  };
  // tile tl's rows from shared memory to its tokens, 16 bytes a copy (dst:
  // the whole batch's rows)
  auto store_rows = [&](bf16* dst, const bf16* src, int tl, int valid) {
    dst += sample_row(tl) * C;
    for (int i = threadIdx.x; i < SM_N * (C / 8); i += blockDim.x) {
      const int r = i / (C / 8), c = (i - r * (C / 8)) * 8;
      if (NS == 1 || r < valid)
        *reinterpret_cast<uint4*>(dst + token(tl, r) * C + c) =
            *reinterpret_cast<const uint4*>(src + r * SM_LDX + c);
    }
  };
  // tile tl's input rows into xs (zeros past its samples')
  auto stage_x = [&](int tl) {
    const bf16* src =
        static_cast<const bf16*>(input()) + sample_row(tl) * C;
    const int valid = valid_rows(tl);
    for (int i = threadIdx.x; i < SM_N * (C / 8); i += blockDim.x) {
      const int r = i / (C / 8), c = (i - r * (C / 8)) * 8;
      if (NS == 1 || r < valid)
        cp_async_16(xs + r * SM_LDX + c, src + token(tl, r) * C + c);
      else
        *reinterpret_cast<uint4*>(xs + r * SM_LDX + c) =
            uint4{0u, 0u, 0u, 0u};
    }
    cp_async_commit();
  };
  // proj's dense epilogue, through the proj dropout in training (row r
  // of tile tl)
  auto proj_out = [&](int tl, int r, int col, float acc, float bias) {
    const float v = dense_out(acc, bias);
    if constexpr (TRAIN)
      return rnd<bf16>(
          drop(d, PROJ_KEY, (unsigned)(((size_t)tl * SM_N + r) * C + col), v));
    return v;
  };
  BankSums sums;
  if constexpr (TRAIN) bank_sums_zero(sums);
  // the warp's window (its queries) and heads in q, attention and proj
  const int win = warp >> 1, half = warp & 1;
  const int qcol = half * (C / 2);         // first of the warp's 96 columns

  if ((int)blockIdx.x < tiles) stage_x(blockIdx.x);
  for (int tl = blockIdx.x; tl < tiles; tl += gridDim.x) {
    const int valid = valid_rows(tl);
    cp_async_wait<0>();
    __syncthreads();
    const bf16* kv_in = xs;                // the rows kv is made from
    if constexpr (MSDA) {
      // the pooled rows; ring_gemm's first barrier orders them before
      // their reads (its ring and they do not overlap)
      for (int i = threadIdx.x; i < SM_N * C; i += blockDim.x) {
        const int r = i / C, c = i - r * C, p = r % NT;
        const bf16* x0 = xs + (r - p) * SM_LDX + c;   // the sample's rows
        float acc = 0.f;
        if (p < keep)
          for (int q = 0; q < pool_n[p]; ++q)
            acc = fmaf(pool_w[p * SM_POOL + q],
                       to_f<bf16>(x0[pool_src[p * SM_POOL + q] * SM_LDX]),
                       acc);
        pooled[r * SM_LDX + c] = from_f<bf16>(acc);
      }
      kv_in = pooled;
    } else {
      // xn = norm1(x) in place, then to device memory in token order
      ln_rows<SM_N, SM_C>(xs, xs, SM_LDX, a.norm1_s, a.norm1_b);
      __syncthreads();
      store_rows(static_cast<bf16*>(a.xn), xs, tl, valid);
    }
    {  // kv = kv_in @ W_kv + b: warp w, columns 48w.. of 384, all 64 rows;
       // W_kv streams through kcvc's space
      float acc[4][6][4];
      ring_gemm<4, 6, SM_STAGES>(kv_in, SM_LDX, m.qkv_w16 + C, 3 * C, 2 * C,
                                 C, kcvc, SM_LDKV, 48 * warp, acc);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
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
    {  // kc | vc of window win = rnd(E^T @ k | v of its 16 rows): warp
       // (win, half) computes k (half 0) or v (half 1), 48 columns a step
      const bf16* ew = et + half * SM_LK * SM_LDE;
      const bf16* src = kv + win * NT * SM_LDKV + half * C;
      bf16* dst = kcvc + (2 * win + half) * SM_LK * SM_LDX;
      unsigned af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        load_a(af[mi], ew + mi * 16 * SM_LDE, SM_LDE, lane);
      bool nan_seen = false;
      for (int c0 = 0; c0 < C; c0 += 48) {
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
      if (d.guard && nan_seen) bad = 1;
    }
    __syncthreads();
    // q = xn @ W_q + b: warp (win, half) rows 16 win.., columns qcol..;
    // k | v are read, W_q streams through their space
    unsigned qa[2][3][4];            // [head][16-column step] A fragments
    {
      float acc[1][12][4];
      ring_gemm<1, 12, SM_STAGES>(xs + win * NT * SM_LDX, SM_LDX, m.qkv_w16,
                                  3 * C, C, C, kv, SM_LDX, qcol, acc);
      if (q_fragments(acc, a.qkv_b, qcol, qa) && d.guard) bad = 1;
    }
    // xs is free: bring the next tile's rows while this one finishes
    if (tl + (int)gridDim.x < tiles) stage_x(tl + gridDim.x);
    {  // attention of the window's 16 queries, heads 2 half and 2 half + 1,
       // over its 32 compressed keys and SM_S bank keys (past 32 + S: -inf)
      const bf16* kc = kcvc + 2 * win * SM_LK * SM_LDX;
      const bf16* vc = kc + SM_LK * SM_LDX;
      const bf16* const kt[3] = {kc, kc + 16 * SM_LDX, bk};
      const bf16* const vt[3] = {vc, vc + 16 * SM_LDX, bv};
      bool nan_seen = false;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int hc = (2 * half + hh) * ATT_D;
        if constexpr (TRAIN) {
          // the window is 4 tl + win of the [B nw] windows (NS = 4: the
          // sample; NS = 1: b nw + w), whose mask the dropout replays
          const AttnMask am{attn_drop(d, ATTN_KEY),
                            (unsigned)(4 * tl + win) * SM_H * NT *
                                (SM_LK + S),
                            2 * half + hh, SM_LK + S};
          nan_seen |= warp_attention_train<3>(qa[hh], kt, vt, SM_LDX, hc,
                                              SM_LK + S, am,
                                              att + win * NT * SM_LDX,
                                              SM_LDX);
        } else {
          nan_seen |= warp_attention<3>(qa[hh], kt, vt, SM_LDX, hc,
                                        SM_LK + S, att + win * NT * SM_LDX,
                                        SM_LDX);
        }
      }
      if (d.guard && nan_seen) bad = 1;
    }
    __syncthreads();
    {  // proj = att @ W_p + b; kc | vc are read, W_p streams through
       // their space; the rows replace att's, then go to their tokens
      float acc[1][12][4];
      ring_gemm<1, 12, SM_STAGES>(att + win * NT * SM_LDX, SM_LDX,
                                  m.proj_w16, C, C, C, kcvc, SM_LDX, qcol,
                                  acc);
#pragma unroll
      for (int j = 0; j < 12; ++j) {
        const int col = qcol + 8 * j + 2 * t;
        const float b0 = a.proj_b[col], b1 = a.proj_b[col + 1];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = win * NT + g + 8 * hf;
          store_bf16x2(att + r * SM_LDX + col,
                       pack_bf16x2(proj_out(tl, r, col, acc[0][j][2 * hf], b0),
                                   proj_out(tl, r, col + 1,
                                            acc[0][j][2 * hf + 1], b1)));
        }
      }
    }
    __syncthreads();
    store_rows(static_cast<bf16*>(a.out), att, tl, valid);
    if constexpr (PARTS)
      bank_tile_partials<SN>(att, SM_LDX, valid, a.bw, S, scratch, sums);
  }
  if constexpr (PARTS)
    bank_store_partials(sums, a.bw, S, scratch,
                        a.bw.part + (size_t)blockIdx.x * 2 * S * C);
  if (d.guard)
    finish_guard(a.ws, bad, [&] {
      // the redo: a zero attention output, so every row of every sample
      // is proj(0) = rnd(rnd(0) + rnd(bias)), through the proj dropout in
      // training; there every block's partials restart here, this block
      // summing the whole batch's
      bf16* out = static_cast<bf16*>(a.out);
      if constexpr (TRAIN) {
        if constexpr (PARTS)
          for (int i = threadIdx.x; i < d.grid * 2 * S * C; i += blockDim.x)
            a.bw.part[i] = 0.f;
        bank_sums_zero(sums);
        for (int tl = 0; tl < tiles; ++tl) {
          const int valid = valid_rows(tl);
          for (int i = threadIdx.x; i < SM_N * C / 2; i += blockDim.x) {
            const int r = 2 * i / C, col = 2 * i - r * C;
            store_bf16x2(att + r * SM_LDX + col,
                         pack_bf16x2(proj_out(tl, r, col, 0.f,
                                              a.proj_b[col]),
                                     proj_out(tl, r, col + 1, 0.f,
                                              a.proj_b[col + 1])));
          }
          __syncthreads();
          store_rows(out, att, tl, valid);
          if constexpr (PARTS)
            bank_tile_partials<SN>(att, SM_LDX, valid, a.bw, S, scratch,
                                   sums);
          else
            __syncthreads();
        }
        if constexpr (PARTS)
          bank_store_partials(sums, a.bw, S, scratch,
                              a.bw.part + (size_t)blockIdx.x * 2 * S * C);
      } else {
        for (size_t i = threadIdx.x; i < (size_t)d.B * d.n * C / 2;
             i += blockDim.x) {
          const int col = (int)(2 * i % C);
          store_bf16x2(out + 2 * i,
                       pack_bf16x2(dense_out(0.f, a.proj_b[col]),
                                   dense_out(0.f, a.proj_b[col + 1])));
        }
      }
    });
}

}  // namespace qv
