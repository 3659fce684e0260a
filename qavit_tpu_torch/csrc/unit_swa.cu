// Unit 1 of the fused block, forward (eval and train): norm1 LayerNorm +
// SWA branch.
//
// Replaces the TPU unit qavit_tpu/kernels/fused_kernels.py
// make_cores.core_swa (fused_cores.py:672 swa_bd), run through
// fused_pallas.py:190-212 fwd_call.
//
// Per window of 16 tokens (the whole 4x4 sample of hqavit_c100, or one of
// the four 4x4 windows of hqavit_tiny_in's 8x8 grid, gathered from the
// sample's rows and scattered back, fused_ref.window_partition):
// xn = LN(x); qkv = xn @ W[192, 576]; Linformer E_k/E_v take the 16
// window tokens to 32 rows; the 16 raw bank rows are appended (kv = 48);
// 4-head softmax attention; proj 192 -> 192.  Each (sample, window) is a
// block in eval, so the shared memory per block is the same at n = 64.
// In training (one window per sample) the attention-probability and proj
// dropout masks come from the counter hash (common.cuh), and the branch
// LN feeds the bank-write partial sums, kept per block and summed over
// the blocks by the reduction pass.
//
// Bound on the H100 at B=1024 (bf16): it reads 6.3 MB and writes 12.6 MB
// (~5.6 us at 3.35 TB/s) and does ~5.9 GFLOP (~6 us at 989 TFLOP/s), so
// the card could finish it in ~6 us; neither bytes nor FLOPs dominate.
// This first design is latency-bound instead: 256 threads hold one
// sample at a time with ~148 KB of shared memory (one block per SM),
// float32 FMAs on the CUDA cores.  It keeps every intermediate out of
// device memory, which is what the bound rewards; tensor cores (wgmma)
// and several samples per block are later work.
//
// n = 64 (hqavit_tiny_in / hqavit_proc_tin, eval): float32 runs
// swa_kernel, one block per (sample, window).  bf16 runs swa_mma_kernel.
// Bound on the H100 at B=1024: 76 MB of x, out, xn and the float32
// weights (~23 us at 3.35 TB/s) against 23.4 GFLOP (~24 us at 989
// TFLOP/s), most of them the kv, q and proj products: the operations
// bound it, so every product runs on the tensor cores (mma.sync
// m16n8k16, bf16 operands, float32 sums; mma.cuh, mma_ops.cuh).  One
// block per SM walks the samples, a sample's four windows in one pass,
// every value the plain version rounds to bf16 held as bf16 in shared
// memory (194 KB).  Per sample: norm1 by eight lanes a row (xn also
// to device memory); kv = xn @ W_kv + b over all 64 rows, W_kv streamed
// once per sample in 32-row slices through a three-buffer cp.async ring;
// kc | vc = rnd(E^T @ k | v) per window (32 x 16 x 192, one warp per
// window and k or v); then each warp takes one window's 16 queries x 2
// heads: q through the ring straight into A fragments, the 48 scores a
// head in registers, softmax, rnd(P) V (warp_attention); proj through the
// ring; the rows go to their tokens as 16-byte copies.  Each ring lives
// in space that the product's step no longer needs (kv's and proj's in
// kc | vc's, q's in kv's).  While attention and proj run, cp.async
// brings the next sample's x.  The weights reach the kernel as bf16 (the
// wrapper's cast is the kernel's own rounding of them).  The batch-wide
// NaN guard is kept: q, kc, vc, the bank and the attention output are
// checked, and the redo writes proj(0) to every sample.  Time at B=1024
// on an NVIDIA H100 80GB HBM3, 700.00 W: PERF.md section 6 row 1 @n64.
#include "mma_ops.cuh"
#include "unit_swa.cuh"

namespace qv {

__host__ __device__ inline int swa_smem_floats(const Dims& d) {
  const int c = d.c;
  return NT * c           // x, then the attention output, then LN(out)
         + NT * c         // xn, then the partials' compressed rows
         + NT * 3 * c     // qkv, then the proj output
         + 2 * d.lin_k * c  // compressed k, v
         + 2 * d.bank_s * c // bank k, v
         + pad4(d.heads * NT * (d.lin_k + d.bank_s))  // scores, gates
         + 2 * NT;        // LN stats
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS, 1) swa_kernel(SwaArgs a) {
  QV_SMEM_DECL
  __shared__ int bad;
  const Dims& d = a.d;
  const int c = d.c, lk = d.lin_k, S = d.bank_s;
  float* x = qv_smem;
  float* xn = x + NT * c;
  float* qkv = xn + NT * c;
  float* kc = qkv + NT * 3 * c;
  float* vc = kc + lk * c;
  float* bk = vc + lk * c;
  float* bv = bk + S * c;
  float* sc = bv + S * c;
  float* stats = sc + pad4(d.heads * NT * (lk + S));
  const SwaBufs s{x, xn, qkv, kc, vc, bk, bv, sc, sc, x, qkv, stats};
  float* part = d.train ? a.bw.part + (size_t)blockIdx.x * 2 * S * c : nullptr;

  if (threadIdx.x == 0) bad = 0;
  load_rounded<T>(bk, a.bank_k, S * c);
  load_rounded<T>(bv, a.bank_v, S * c);
  if (part != nullptr) fill(part, 2 * S * c, 0.f);
  __syncthreads();
  // window bw = b * nw + w; the bank partials (training) need the whole
  // sample in one window (the wrapper refuses training otherwise)
  auto window = [&](int bw, bool zero_attn, float* acc) {
    swa_body<T>(a, bw, zero_attn, s, &bad);
    const int b = bw / d.nw, w = bw - b * d.nw;
    const size_t off = (size_t)b * d.n * c;
    store_window<T>(static_cast<T*>(a.xn) + off, xn, d, w, c);
    store_window<T>(static_cast<T*>(a.out) + off, qkv, d, w, c);
    __syncthreads();
    if (acc != nullptr)
      bank_partials<T>(qkv, a.bw, c, S, x, xn, sc, stats, acc);
  };
  const int windows = d.B * d.nw;
  for (int bw = blockIdx.x; bw < windows; bw += gridDim.x)
    window(bw, false, part);
  if (d.guard)
    finish_guard(a.ws, bad, [&] {
      if (part != nullptr) {   // every block's partials restart here
        fill(a.bw.part, d.grid * 2 * S * c, 0.f);
        __syncthreads();
      }
      for (int bw = 0; bw < windows; ++bw) window(bw, true, part);
    });
}

// --- n = 64, bf16: the tensor-core kernel -----------------------------------

struct SwaMmaArgs {
  SwaArgs f;              // the unit's arguments (f.qkv_w, f.proj_w unread)
  const bf16* qkv_w16;    // [C, 3C] qkv_w rounded to bf16
  const bf16* proj_w16;   // [C, C]
};

// the geometry swa_mma_kernel is written for (fused_kernels.swa_mma_error)
constexpr int SM_N = 64, SM_C = 192, SM_H = 4, SM_NW = 4, SM_SIDE = 8;
constexpr int SM_LK = 32;               // compressed keys of a window
constexpr int SM_S = 16;                // bank rows, at most
static_assert(SM_C / SM_H == ATT_D, "warp_attention's head width");
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
static_assert(SM_STAGES * RING_KS * SM_LDKV <= SM_KCVC, "the kv ring");
static_assert(SM_STAGES * RING_KS * SM_LDX <= SM_KV, "the q ring");
constexpr int SM_SMEM_BYTES = 2 * (SM_BANK + SM_ET + SM_XS + SM_KV + SM_KCVC);

// One block per SM walks the samples, the four windows of a sample in one
// pass; the rows of xs, kv and att are window-major (row 16 w + i is
// token window_row(w, i)), so a window is an m16 tile and the gather and
// scatter of load_window / store_window are row indexing.
__global__ void __launch_bounds__(NTHREADS, 1) swa_mma_kernel(SwaMmaArgs m) {
  QV_SMEM_DECL
  __shared__ int bad;
  const SwaArgs& a = m.f;
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

  if (threadIdx.x == 0) bad = 0;
  __syncthreads();
  // per block: the bank rows rounded (rows past S zero), E_k^T and E_v^T
  // rounded ([lin_k, 16] each)
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
        from_f<bf16>(rnd<bf16>(e[k * SM_LK + mrow]));
  }

  // the sample's token of row r
  auto token = [&](int r) {
    const int i = r & (NT - 1);
    return window_base(d, r / NT) + (i / WS) * SM_SIDE + i % WS;
  };
  // a sample's rows from shared memory to its tokens, 16 bytes a copy
  auto store_rows = [&](bf16* dst, const bf16* src) {
    for (int i = threadIdx.x; i < SM_N * (C / 8); i += blockDim.x) {
      const int r = i / (C / 8), c = (i - r * (C / 8)) * 8;
      *reinterpret_cast<uint4*>(dst + token(r) * C + c) =
          *reinterpret_cast<const uint4*>(src + r * SM_LDX + c);
    }
  };
  auto stage_x = [&](int b) {
    const bf16* src = static_cast<const bf16*>(a.x) + (size_t)b * SM_N * C;
    for (int i = threadIdx.x; i < SM_N * (C / 8); i += blockDim.x) {
      const int r = i / (C / 8), c = (i - r * (C / 8)) * 8;
      cp_async_16(xs + r * SM_LDX + c, src + token(r) * C + c);
    }
    cp_async_commit();
  };
  // the warp's window (its queries) and heads in q, attention and proj
  const int win = warp >> 1, half = warp & 1;
  const int qcol = half * (C / 2);         // first of the warp's 96 columns

  if (blockIdx.x < d.B) stage_x(blockIdx.x);
  for (int b = blockIdx.x; b < d.B; b += gridDim.x) {
    cp_async_wait<0>();
    __syncthreads();
    // xn = norm1(x) in place, then to device memory in token order
    ln_rows<SM_N, SM_C>(xs, xs, SM_LDX, a.norm1_s, a.norm1_b);
    __syncthreads();
    store_rows(static_cast<bf16*>(a.xn) + (size_t)b * SM_N * C, xs);
    {  // kv = xn @ W_kv + b: warp w, columns 48w.. of 384, all 64 rows;
       // W_kv streams through kcvc's space
      float acc[4][6][4];
      ring_gemm<4, 6, SM_STAGES>(xs, SM_LDX, m.qkv_w16 + C, 3 * C, 2 * C, C,
                                 kcvc, SM_LDKV, 48 * warp, acc);
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
    // xs is free: bring the next sample's x while this one finishes
    if (b + (int)gridDim.x < d.B) stage_x(b + gridDim.x);
    {  // attention of the window's 16 queries, heads 2 half and 2 half + 1,
       // over its 32 compressed keys and SM_S bank keys (past 32 + S: -inf)
      const bf16* kc = kcvc + 2 * win * SM_LK * SM_LDX;
      const bf16* vc = kc + SM_LK * SM_LDX;
      const bf16* const kt[3] = {kc, kc + 16 * SM_LDX, bk};
      const bf16* const vt[3] = {vc, vc + 16 * SM_LDX, bv};
      bool nan_seen = false;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        nan_seen |= warp_attention<3>(qa[hh], kt, vt, SM_LDX,
                                      (2 * half + hh) * ATT_D, SM_LK + S,
                                      att + win * NT * SM_LDX, SM_LDX);
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
        for (int hf = 0; hf < 2; ++hf)
          store_bf16x2(att + (win * NT + g + 8 * hf) * SM_LDX + col,
                       pack_bf16x2(dense_out(acc[0][j][2 * hf], b0),
                                   dense_out(acc[0][j][2 * hf + 1], b1)));
      }
    }
    __syncthreads();
    store_rows(static_cast<bf16*>(a.out) + (size_t)b * SM_N * C, att);
  }
  if (d.guard)
    finish_guard(a.ws, bad, [&] {
      // the redo: a zero attention output, so every row of every sample is
      // proj(0) = rnd(rnd(0) + rnd(bias))
      bf16* out = static_cast<bf16*>(a.out);
      for (size_t i = threadIdx.x; i < (size_t)d.B * SM_N * C / 2;
           i += blockDim.x) {
        const int col = (int)(2 * i % C);
        store_bf16x2(out + 2 * i, pack_bf16x2(dense_out(0.f, a.proj_b[col]),
                                              dense_out(0.f,
                                                        a.proj_b[col + 1])));
      }
    });
}

}  // namespace qv

extern "C" int qv_unit_swa(const qv::SwaArgs* a, int is_bf16, void* stream) {
  // several windows: eval only, bf16 is qv_unit_swa_mma's
  if (a->d.nw != 1 && (a->d.train || is_bf16)) return qv::ERR_ARGS;
  const size_t smem = qv::swa_smem_floats(a->d) * sizeof(float);
  const int rc = is_bf16
                     ? qv_launch(qv::swa_kernel<qv::bf16>, *a, smem, stream,
                                     a->d.grid)
                     : qv_launch(qv::swa_kernel<float>, *a, smem, stream,
                                     a->d.grid);
  if (rc != 0 || !a->d.train) return rc;
  return qv_reduce(a->bw.part, a->bw.part_out, a->d.grid,
                   2 * a->d.bank_s * a->d.c, a->d.rgrid, stream);
}

extern "C" int qv_unit_swa_smem(const qv::Dims* d) {
  return qv::swa_smem_floats(*d) * (int)sizeof(float);
}

// The n = 64 bf16 eval kernel: `a` as for qv_unit_swa, the qkv and proj
// kernels rounded to bf16 beside it.  ERR_ARGS for any other geometry or
// type (the wrapper checks them first, swa_mma_error).
extern "C" int qv_unit_swa_mma(const qv::SwaArgs* a, const void* qkv_w16,
                               const void* proj_w16, int is_bf16,
                               void* stream) {
  const qv::Dims& d = a->d;
  if (!is_bf16 || d.train || d.n != qv::SM_N || d.nw != qv::SM_NW ||
      d.side != qv::SM_SIDE || d.c != qv::SM_C || d.heads != qv::SM_H ||
      d.lin_k != qv::SM_LK || d.bank_s > qv::SM_S || d.grid > d.B)
    return qv::ERR_ARGS;
  const qv::SwaMmaArgs m{*a, static_cast<const qv::bf16*>(qkv_w16),
                         static_cast<const qv::bf16*>(proj_w16)};
  return qv_launch(qv::swa_mma_kernel, m, qv::SM_SMEM_BYTES, stream,
                   d.grid);
}

extern "C" int qv_unit_swa_mma_smem(const qv::Dims*) {
  return qv::SM_SMEM_BYTES;
}
