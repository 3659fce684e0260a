// The pieces the bf16 tensor-core unit kernels share (msda_mma_kernel,
// swa_mma_kernel, msda_mma16_kernel, cross_tail_mma_kernel,
// cga_mma_kernel), built on mma.cuh's primitives: a product whose weight
// streams through a ring of cp.async buffers, a dense layer's epilogue,
// the q fragments of a warp's two heads, one warp's softmax attention of
// 16 queries with its scores in registers, a warp-per-row LayerNorm of
// bf16 rows, and the bank-write partials of the train-mode forwards.
// Then the pieces of the backward kernels (swa_bwd_mma_kernel,
// msda_bwd_mma_kernel, msda_bwd_mma64_kernel, cross_tail_bwd_mma_kernel,
// cga_bwd_mma_kernel), which walk the batch in passes of 32 rows (two
// samples or windows of 16 tokens, half an n = 64 sample, MSDA's n = 64
// queries) or 64 (CGA: four samples of 16, or one of 64): products over
// a pass's rows with an epilogue per pair
// of columns, weight gradients in^T @ dy over every row of the block,
// stored once into its float32 slice from operand rows the passes saved,
// the LayerNorm backward, and the attention with its dropout and its
// backward, one warp per 16 queries and head.
#pragma once
#include "mma.cuh"

namespace qv {

constexpr int RING_KS = 32;   // weight rows per ring slice
constexpr int ATT_D = 48;     // head width of warp_attention

// acc[mt][j] = A @ W over the warp's 16-row tiles mt (A's rows from a, in
// shared memory, leading dim lda, K columns) and 8-column tiles j from
// column n0: W is bf16 [K, ldw] in device memory, its N columns staged in
// RING_KS-row slices through a ring of STAGES buffers (leading dim ldr,
// STAGES * RING_KS * ldr elements) by cp.async, STAGES - 1 slices in
// flight while one is multiplied.  Block-wide: every thread calls it
// (each warp with its own a and n0); the ring is free again on return.
// Its first wait also completes every copy committed before the call.
template <int MT, int NT8, int STAGES = 2>
__device__ __forceinline__ void ring_gemm(const bf16* a, int lda, const bf16* W, int ldw,
                          int N, int K, bf16* ring, int ldr, int n0,
                          float (&acc)[MT][NT8][4]) {
  const int lane = threadIdx.x & 31, cpr = N / 8, nsl = K / RING_KS;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NT8; ++j)
      acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.f;
  // slice sl into buffer sl % STAGES; past the last slice an empty group,
  // so that every wait below counts the same groups
  auto issue = [&](int sl) {
    if (sl < nsl) {
      bf16* dst = ring + (sl % STAGES) * RING_KS * ldr;
      const bf16* src = W + (size_t)sl * RING_KS * ldw;
      for (int i = threadIdx.x; i < RING_KS * cpr; i += blockDim.x) {
        const int r = i / cpr, c = (i - r * cpr) * 8;
        cp_async_16(dst + r * ldr + c, src + (size_t)r * ldw + c);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int sl = 0; sl < STAGES - 1; ++sl) issue(sl);
  for (int sl = 0; sl < nsl; ++sl) {
    cp_async_wait<STAGES - 2>();   // slice sl has landed
    // every warp is past slice sl - 1, whose buffer the next issue reuses
    __syncthreads();
    issue(sl + STAGES - 1);
    const bf16* buf = ring + (sl % STAGES) * RING_KS * ldr;
#pragma unroll
    for (int kk = 0; kk < RING_KS / 16; ++kk) {
      unsigned af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        load_a(af[mt], a + mt * 16 * lda + sl * RING_KS + kk * 16, lda, lane);
#pragma unroll
      for (int np = 0; np < NT8 / 2; ++np) {
        unsigned wb[4];
        load_b_kn(wb, buf + kk * 16 * ldr + n0 + np * 16, ldr, lane);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16_16816(acc[mt][2 * np], af[mt], wb);
          mma_bf16_16816(acc[mt][2 * np + 1], af[mt], wb + 2);
        }
      }
    }
  }
  __syncthreads();
}

// A dense layer's epilogue, as dense_rows: rnd(rnd(acc) + rnd(bias))
__device__ __forceinline__ float dense_out(float acc, float bias) {
  return rnd<bf16>(rnd<bf16>(acc) + rnd<bf16>(bias));
}

// The warp's q (ring_gemm<1, 12>: 16 rows x the 96 columns from qcol,
// two heads of ATT_D) with its dense epilogue, rounded straight into the
// A fragments qa[head][16-column step] of the score product (mma.cuh:
// two neighbouring C tiles are one A fragment); true if a q is NaN.
__device__ __forceinline__ bool q_fragments(float (&acc)[1][12][4],
                                            const float* bias, int qcol,
                                            unsigned (&qa)[2][3][4]) {
  const int t = threadIdx.x & 3;
  bool nan_seen = false;
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    const int col = qcol + 8 * j + 2 * t;
    const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[0][j][e] = dense_out(acc[0][j][e], e & 1 ? b1 : b0);
      nan_seen = nan_seen || isnan(acc[0][j][e]);
    }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int ks = 0; ks < 3; ++ks) {
      const float* c0 = acc[0][6 * hh + 2 * ks];
      const float* c1 = acc[0][6 * hh + 2 * ks + 1];
      qa[hh][ks][0] = pack_bf16x2(c0[0], c0[1]);
      qa[hh][ks][1] = pack_bf16x2(c0[2], c0[3]);
      qa[hh][ks][2] = pack_bf16x2(c1[0], c1[1]);
      qa[hh][ks][3] = pack_bf16x2(c1[2], c1[3]);
    }
  return nan_seen;
}

// Softmax attention of one warp's 16 queries in one head of ATT_D
// columns (from hc): q as the A fragments qa[16-column step]; keys and
// values in NKT tiles of 16 rows each (kt[i], vt[i]: row-major [key][C],
// leading dim ld), keys from nkeys on masked to -inf.  The scores stay in
// registers, divided by sqrt(D) as common.cuh's attention divides them;
// float32 softmax by quad shuffles, rnd(P) V; the 16 output rows go to
// out (leading dim ldo, columns hc..) rounded to bf16.  True if an
// output is NaN.
template <int NKT>
__device__ __forceinline__ bool warp_attention(const unsigned (&qa)[3][4],
                                               const bf16* const (&kt)[NKT],
                                               const bf16* const (&vt)[NKT],
                                               int ld, int hc, int nkeys,
                                               bf16* out, int ldo) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float sqrt_d = sqrtf((float)ATT_D);
  float s[2 * NKT][4];
#pragma unroll
  for (int j = 0; j < 2 * NKT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < ATT_D / 16; ++ks)
#pragma unroll
    for (int np = 0; np < NKT; ++np) {
      unsigned kb[4];
      load_b_nk(kb, kt[np] + hc + ks * 16, ld, lane);
      mma_bf16_16816(s[2 * np], qa[ks], kb);
      mma_bf16_16816(s[2 * np + 1], qa[ks], kb + 2);
    }
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < 2 * NKT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool in = 8 * j + 2 * t + e < nkeys;
      s[j][e] = in ? s[j][e] / sqrt_d : -INFINITY;
      s[j][2 + e] = in ? s[j][2 + e] / sqrt_d : -INFINITY;
      m0 = fmaxf(m0, s[j][e]);
      m1 = fmaxf(m1, s[j][2 + e]);
    }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
  }
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int j = 0; j < 2 * NKT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[j][e] = expf(s[j][e] - m0);
      s[j][2 + e] = expf(s[j][2 + e] - m1);
      l0 += s[j][e];
      l1 += s[j][2 + e];
    }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }
  float o[6][4];
#pragma unroll
  for (int j = 0; j < 6; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < NKT; ++kk) {
    const unsigned pa[4] = {
        pack_bf16x2(s[2 * kk][0] / l0, s[2 * kk][1] / l0),
        pack_bf16x2(s[2 * kk][2] / l1, s[2 * kk][3] / l1),
        pack_bf16x2(s[2 * kk + 1][0] / l0, s[2 * kk + 1][1] / l0),
        pack_bf16x2(s[2 * kk + 1][2] / l1, s[2 * kk + 1][3] / l1)};
#pragma unroll
    for (int dp = 0; dp < ATT_D / 16; ++dp) {
      unsigned vb[4];
      load_b_kn(vb, vt[kk] + hc + dp * 16, ld, lane);
      mma_bf16_16816(o[2 * dp], pa, vb);
      mma_bf16_16816(o[2 * dp + 1], pa, vb + 2);
    }
  }
  bool nan_seen = false;
#pragma unroll
  for (int j = 0; j < 6; ++j)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float x0 = o[j][2 * hf], x1 = o[j][2 * hf + 1];
      nan_seen = nan_seen || isnan(x0) || isnan(x1);
      store_bf16x2(out + (g + 8 * hf) * ldo + hc + 8 * j + 2 * t,
                   pack_bf16x2(x0, x1));
    }
  return nan_seen;
}

// LayerNorm of ROWS bf16 rows of COLS columns (flax form: float32
// statistics, variance E[x^2] - mu^2 clamped at 0, as layer_norm_rows),
// from in to out (either leading dim ld; out may equal in).  Eight lanes
// share a row, each the column pairs 2 li + 16 k, so a warp normalises
// four rows at once and reduces each over three shuffles.  A thread
// loads its columns' scales and biases first, all at once, then holds
// its ROWS / 32 rows' values in registers, so that their loads and
// shuffles overlap.  Block-wide, without a barrier.
template <int ROWS, int COLS>
__device__ __forceinline__ void ln_rows(const bf16* in, bf16* out, int ld,
                                        const float* scale,
                                        const float* bias) {
  constexpr int P = COLS / 16;             // column pairs of a lane
  constexpr int R = ROWS / (NTHREADS / 8);  // rows of a thread
  static_assert(P * 16 == COLS && R * (NTHREADS / 8) == ROWS,
                "whole column pairs and rows per thread");
  const int sub = threadIdx.x >> 3, c0 = 2 * (threadIdx.x & 7);
  float sc[2 * P], bi[2 * P];
#pragma unroll
  for (int k = 0; k < P; ++k)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      sc[2 * k + e] = scale[c0 + 16 * k + e];
      bi[2 * k + e] = bias[c0 + 16 * k + e];
    }
  float v[R][2 * P], sum[R], sq[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const bf16* src = in + (sub + i * (NTHREADS / 8)) * ld + c0;
    sum[i] = sq[i] = 0.f;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const unsigned u = *reinterpret_cast<const unsigned*>(src + 16 * k);
      v[i][2 * k] = bf16x2_lo(u);
      v[i][2 * k + 1] = bf16x2_hi(u);
      sum[i] += v[i][2 * k] + v[i][2 * k + 1];
      sq[i] += v[i][2 * k] * v[i][2 * k] + v[i][2 * k + 1] * v[i][2 * k + 1];
    }
  }
#pragma unroll
  for (int o = 4; o > 0; o >>= 1)
#pragma unroll
    for (int i = 0; i < R; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], o);
      sq[i] += __shfl_xor_sync(0xffffffffu, sq[i], o);
    }
  float mu[R], rstd[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    mu[i] = sum[i] / COLS;
    rstd[i] = rsqrtf(fmaxf(sq[i] / COLS - mu[i] * mu[i], 0.f) + LN_EPS);
  }
#pragma unroll
  for (int k = 0; k < P; ++k)
#pragma unroll
    for (int i = 0; i < R; ++i)
      store_bf16x2(
          out + (sub + i * (NTHREADS / 8)) * ld + c0 + 16 * k,
          pack_bf16x2(
              (v[i][2 * k] - mu[i]) * rstd[i] * sc[2 * k] + bi[2 * k],
              (v[i][2 * k + 1] - mu[i]) * rstd[i] * sc[2 * k + 1] +
                  bi[2 * k + 1]));
}

// --- the bank-write partials of the train-mode tensor-core forwards ---------
//
// fused_ref.bank_write_partial, per sample of 16 rows: normed =
// rnd(LN(out; the branch's norm)), t = LN(normed; write_norm) with
// jnp.var's two-pass variance, comp = t @ Wc + bc, gate = softmax over the
// sample's tokens of t @ Wg + bg, all float32; part_k[m] = sum_n gate[n, m]
// comp[n] and part_v[m] = sum_n gate[n, m] t[n], summed over the batch.
// Since the gate of a sample sums to 1 over its tokens, part_k = part_v @
// Wc + (sum_n gate[n, m]) bc: so a block sums only part_v and the gates
// over its rows, in float32 FMAs (the 1e-4 tolerance of the partials is
// beyond bf16 or TF32 operands), and forms its part_k from them once, at
// the end.  A 192 x 192 product a row (2.4 M FMAs a tile of 64) becomes
// one of 16 rows a block.

constexpr int BP_C = 192;                        // the width they are for
constexpr int BP_S = 16;                         // bank rows, at most
constexpr int BP_ROWS = 64;                      // rows of a tile
constexpr int BP_LDT = BP_C + 4;                 // t's leading dim (floats)
static_assert(BP_C <= NTHREADS, "a thread a column");
// scratch of bank_tile_partials, floats: t [64][BP_LDT], gate [64][BP_S],
// the gate's kernel [C][BP_S]
constexpr int BP_SCRATCH = BP_ROWS * (BP_LDT + BP_S) + BP_C * BP_S;

// A thread's part of a block's sums: thread c < C holds part_v[m, c] for
// every m < BP_S (zero past S), thread m < S the gates' sum of bank row m.
struct BankSums {
  float v[BP_S];
  float gate;
};

__device__ __forceinline__ void bank_sums_zero(BankSums& acc) {
#pragma unroll
  for (int m = 0; m < BP_S; ++m) acc.v[m] = 0.f;
  acc.gate = 0.f;
}

// The partials of the samples in a tile's first `rows` rows (a multiple
// of SN; a short last tile's rows past its samples are left out), from
// their bf16 branch outputs `out` (leading dim ld), added to acc; SN the
// rows of a sample, over which its gate's softmax runs (16, or 64: the
// tile is one sample).  scratch: BP_SCRATCH floats.  Block-wide; ends
// with a barrier.
template <int SN = NT>
__device__ __forceinline__ void bank_tile_partials(const bf16* out, int ld,
                                                   int rows,
                                                   const BankWrite& bw, int S,
                                                   float* scratch,
                                                   BankSums& acc) {
  constexpr int P = BP_C / 16;             // column pairs of a lane
  float* t = scratch;
  float* gate = t + BP_ROWS * BP_LDT;
  float* wg = gate + BP_ROWS * BP_S;       // [C][BP_S], zero past S
  for (int i = threadIdx.x; i < BP_C * BP_S; i += NTHREADS) {
    const int k = i / BP_S, m = i - k * BP_S;
    wg[i] = m < S ? bw.gate_w[k * S + m] : 0.f;
  }
  // t of every row, eight lanes a row (as ln_rows), two rows a thread
  const int sub = threadIdx.x >> 3, c0 = 2 * (threadIdx.x & 7);
#pragma unroll 1
  for (int i = 0; i < BP_ROWS / (NTHREADS / 8); ++i) {
    const int r = sub + i * (NTHREADS / 8);
    float v[2 * P], s = 0.f, sq = 0.f;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const unsigned u =
          *reinterpret_cast<const unsigned*>(out + r * ld + c0 + 16 * k);
      v[2 * k] = bf16x2_lo(u);
      v[2 * k + 1] = bf16x2_hi(u);
      s += v[2 * k] + v[2 * k + 1];
      sq += v[2 * k] * v[2 * k] + v[2 * k + 1] * v[2 * k + 1];
    }
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      sq += __shfl_xor_sync(0xffffffffu, sq, o);
    }
    const float mu = s / BP_C;
    const float rstd = rsqrtf(fmaxf(sq / BP_C - mu * mu, 0.f) + LN_EPS);
    float s2 = 0.f;
#pragma unroll
    for (int k = 0; k < 2 * P; ++k) {
      const int col = c0 + 16 * (k >> 1) + (k & 1);
      v[k] = rnd<bf16>((v[k] - mu) * rstd * bw.branch_s[col] +
                       bw.branch_b[col]);
      s2 += v[k];
    }
#pragma unroll
    for (int o = 4; o > 0; o >>= 1)
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    const float mu2 = s2 / BP_C;
    float q = 0.f;
#pragma unroll
    for (int k = 0; k < 2 * P; ++k) q += (v[k] - mu2) * (v[k] - mu2);
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) q += __shfl_xor_sync(0xffffffffu, q, o);
    const float rstd2 = rsqrtf(q / BP_C + LN_EPS);
#pragma unroll
    for (int k = 0; k < 2 * P; ++k) {
      const int col = c0 + 16 * (k >> 1) + (k & 1);
      t[r * BP_LDT + col] =
          (v[k] - mu2) * rstd2 * bw.norm_s[col] + bw.norm_b[col];
    }
  }
  __syncthreads();
  {  // the gate's logits t @ Wg + bg: thread (row, four of the 16 columns;
     // zero past S)
    const int r = threadIdx.x >> 2, m0 = 4 * (threadIdx.x & 3);
    float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int k = 0; k < BP_C; ++k) {
      const float tv = t[r * BP_LDT + k];
      const float4 w = *reinterpret_cast<const float4*>(wg + k * BP_S + m0);
      a[0] = fmaf(tv, w.x, a[0]);
      a[1] = fmaf(tv, w.y, a[1]);
      a[2] = fmaf(tv, w.z, a[2]);
      a[3] = fmaf(tv, w.w, a[3]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      gate[r * BP_S + m0 + j] = m0 + j < S ? a[j] + bw.gate_b[m0 + j] : 0.f;
  }
  __syncthreads();
  static_assert(BP_ROWS % SN == 0, "whole samples in a tile");
  if ((int)threadIdx.x < (BP_ROWS / SN) * BP_S) {  // (sample, bank row)
    const int m = threadIdx.x % BP_S;
    float* gp = gate + (threadIdx.x / BP_S) * SN * BP_S + m;
    if (m < S) {
      float mx = -INFINITY;
      for (int n = 0; n < SN; ++n) mx = fmaxf(mx, gp[n * BP_S]);
      float sum = 0.f;
      for (int n = 0; n < SN; ++n) {
        const float e = expf(gp[n * BP_S] - mx);
        gp[n * BP_S] = e;
        sum += e;
      }
      for (int n = 0; n < SN; ++n) gp[n * BP_S] = gp[n * BP_S] / sum;
    }
  }
  __syncthreads();
  if ((int)threadIdx.x < BP_C) {   // part_v of column c, every bank row
    const int c = threadIdx.x;
    for (int r = 0; r < rows; ++r) {
      const float tv = t[r * BP_LDT + c];
#pragma unroll
      for (int m4 = 0; m4 < BP_S; m4 += 4) {
        const float4 gw =
            *reinterpret_cast<const float4*>(gate + r * BP_S + m4);
        acc.v[m4] = fmaf(gw.x, tv, acc.v[m4]);
        acc.v[m4 + 1] = fmaf(gw.y, tv, acc.v[m4 + 1]);
        acc.v[m4 + 2] = fmaf(gw.z, tv, acc.v[m4 + 2]);
        acc.v[m4 + 3] = fmaf(gw.w, tv, acc.v[m4 + 3]);
      }
    }
  }
  if ((int)threadIdx.x < S)
    for (int r = 0; r < rows; ++r) acc.gate += gate[r * BP_S + threadIdx.x];
  __syncthreads();
}

// This block's slice `part` [2, S, C] of the per-block partial sums, each
// element stored once: part_v as summed, part_k = part_v @ Wc + (the
// gates' sum) bc.  scratch: BP_C BP_S + BP_S floats.  Block-wide; ends
// with a barrier.
__device__ __forceinline__ void bank_store_partials(const BankSums& acc,
                                                    const BankWrite& bw,
                                                    int S, float* scratch,
                                                    float* part) {
  float* pv = scratch;                     // [C][BP_S]
  float* gsum = scratch + BP_C * BP_S;
  const int c = threadIdx.x;
  if (c < BP_C)
#pragma unroll
    for (int m = 0; m < BP_S; ++m) {
      pv[c * BP_S + m] = acc.v[m];
      if (m < S) part[S * BP_C + m * BP_C + c] = acc.v[m];
    }
  if (c < S) gsum[c] = acc.gate;
  __syncthreads();
  if (c < BP_C) {
    float a[BP_S];
#pragma unroll
    for (int m = 0; m < BP_S; ++m) a[m] = 0.f;
    // 16 rows of Wc in flight a thread: its loads come from L2
#pragma unroll 16
    for (int k = 0; k < BP_C; ++k) {
      const float w = bw.comp_w[k * BP_C + c];
#pragma unroll
      for (int m4 = 0; m4 < BP_S; m4 += 4) {
        const float4 p = *reinterpret_cast<const float4*>(pv + k * BP_S + m4);
        a[m4] = fmaf(p.x, w, a[m4]);
        a[m4 + 1] = fmaf(p.y, w, a[m4 + 1]);
        a[m4 + 2] = fmaf(p.z, w, a[m4 + 2]);
        a[m4 + 3] = fmaf(p.w, w, a[m4 + 3]);
      }
    }
#pragma unroll
    for (int m = 0; m < BP_S; ++m)
      if (m < S) part[m * BP_C + c] = a[m] + gsum[m] * bw.comp_b[c];
  }
  __syncthreads();
}

// --- the backward kernels' pieces ------------------------------------------

constexpr int PASS_ROWS = 2 * NT;   // rows of a pass: two samples of n = 16

// A fragment of A^T for the 16 x 16 tile whose rows are the 16 columns of
// `a` from its pointer and whose columns are its 16 rows (row-major,
// leading dim ld): ldmatrix's transpose.  A weight gradient's in^T and an
// attention backward's dS^T and P^T take their fragments so.
__device__ __forceinline__ void load_a_t(unsigned r[4], const bf16* a, int ld,
                                         int lane) {
  ldmatrix_x4_trans(r, a + ((lane & 7) + ((lane >> 4) << 3)) * ld +
                           ((lane >> 3) & 1) * 8);
}

// acc[j] += the 16 x 16 tile of A^T B over 16 KS rows (j: its columns 8j..):
// the tile's rows are the 16 columns of a from its pointer, its columns
// the 16 of b from its pointer (both row-major, leading dims lda, ldb)
template <int KS>
__device__ __forceinline__ void mma_tn(float (&acc)[2][4], const bf16* a,
                                       int lda, const bf16* b, int ldb,
                                       int lane) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    unsigned af[4], bf[4];
    load_a_t(af, a + ks * 16 * lda, lda, lane);
    load_b_kn(bf, b + ks * 16 * ldb, ldb, lane);
    mma_bf16_16816(acc[0], af, bf);
    mma_bf16_16816(acc[1], af, bf + 2);
  }
}

// gemm_pass<192, STAGES> (below) with a second K block from shared memory
// in the same float32 sums: epi gets those of A @ W + A2 @ B2 (A2 [32,
// K2], leading dim lda2; B2 [K2, 192], leading dim ldb2; K2 a multiple of
// 16, or 0).  Block-wide; the ring is free again on return.
template <int STAGES, typename F>
__device__ __forceinline__ void gemm_pass_k2(const bf16* a, int lda,
                                             const bf16* W, int ldw, int K,
                                             bf16* ring, const bf16* a2,
                                             int lda2, const bf16* b2,
                                             int ldb2, int K2, F&& epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mt = warp & 1, n0 = 48 * (warp >> 1);
  float acc[1][6][4];
  ring_gemm<1, 6, STAGES>(a + mt * 16 * lda, lda, W, ldw, 192, K, ring, 200,
                          n0, acc);
  for (int ks = 0; ks < K2 / 16; ++ks) {
    unsigned af[4];
    load_a(af, a2 + mt * 16 * lda2 + ks * 16, lda2, lane);
#pragma unroll
    for (int np = 0; np < 3; ++np) {
      unsigned bf[4];
      load_b_kn(bf, b2 + ks * 16 * ldb2 + n0 + np * 16, ldb2, lane);
      mma_bf16_16816(acc[0][2 * np], af, bf);
      mma_bf16_16816(acc[0][2 * np + 1], af, bf + 2);
    }
  }
#pragma unroll
  for (int j = 0; j < 6; ++j)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      epi(16 * mt + g + 8 * hf, n0 + 8 * j + 2 * t, acc[0][j][2 * hf],
          acc[0][j][2 * hf + 1]);
}

// A product over the PASS_ROWS rows of a pass: A (shared memory, leading
// dim lda, K columns) @ W (bf16 [K, ldw] in device memory, N = 192 or 96
// columns) through ring_gemm's ring (STAGES x RING_KS x (N + 8) elements);
// epi(row, col, v0, v1) gets the float32 sums of columns col, col + 1 of
// a row, from the one thread that holds them.  N = 192: warp w the rows
// 16 (w & 1).. and the 48 columns from 48 (w >> 1); N = 96: warps 0-5 all
// rows and 16 columns each (warps 6 and 7 repeat warp 5's and keep
// nothing).  Block-wide; the ring is free again on return.
template <int N, int STAGES, typename F>
__device__ __forceinline__ void gemm_pass(const bf16* a, int lda,
                                          const bf16* W, int ldw, int K,
                                          bf16* ring, F&& epi) {
  static_assert(N == 192 || N == 96, "the pass products' widths");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  if constexpr (N == 96) {
    const int n0 = 16 * (warp < 6 ? warp : 5);
    float acc[2][2][4];
    ring_gemm<2, 2, STAGES>(a, lda, W, ldw, N, K, ring, N + 8, n0, acc);
    if (warp < 6)
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
            epi(16 * mi + g + 8 * hf, n0 + 8 * j + 2 * t,
                acc[mi][j][2 * hf], acc[mi][j][2 * hf + 1]);
  } else {
    gemm_pass_k2<STAGES>(a, lda, W, ldw, K, ring, nullptr, 0, nullptr, 0, 0,
                         epi);
  }
}

// The same with B staged in shared memory (bf16 [K, ldb], K a multiple of
// 16), N = 192, without a barrier.
template <typename F>
__device__ __forceinline__ void gemm_pass_smem(const bf16* a, int lda,
                                               const bf16* b, int ldb, int K,
                                               F&& epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mt = warp & 1, n0 = 48 * (warp >> 1);
  float acc[6][4];
#pragma unroll
  for (int j = 0; j < 6; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  for (int ks = 0; ks < K / 16; ++ks) {
    unsigned af[4];
    load_a(af, a + mt * 16 * lda + ks * 16, lda, lane);
#pragma unroll
    for (int np = 0; np < 3; ++np) {
      unsigned bf[4];
      load_b_kn(bf, b + ks * 16 * ldb + n0 + np * 16, ldb, lane);
      mma_bf16_16816(acc[2 * np], af, bf);
      mma_bf16_16816(acc[2 * np + 1], af, bf + 2);
    }
  }
#pragma unroll
  for (int j = 0; j < 6; ++j)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      epi(16 * mt + g + 8 * hf, n0 + 8 * j + 2 * t, acc[j][2 * hf],
          acc[j][2 * hf + 1]);
}

// A product over 48 rows (three 16-row tiles, one weight stream for all):
// A (shared memory, leading dim lda, K columns) @ W (bf16 [K, ldw] in
// device memory, N = 192) through ring_gemm's ring (STAGES x RING_KS x
// 200 elements); warps 0-5 the 32 columns from 32 w (6 and 7 repeat warp
// 5's and keep nothing); epi as gemm_pass's.  Block-wide; the ring is free
// again on return.
template <int STAGES, typename F>
__device__ __forceinline__ void gemm_pass48(const bf16* a, int lda,
                                            const bf16* W, int ldw, int K,
                                            bf16* ring, F&& epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = 32 * (warp < 6 ? warp : 5);
  float acc[3][4][4];
  ring_gemm<3, 4, STAGES>(a, lda, W, ldw, 192, K, ring, 200, n0, acc);
  if (warp < 6)
#pragma unroll
    for (int mt = 0; mt < 3; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          epi(16 * mt + g + 8 * hf, n0 + 8 * j + 2 * t, acc[mt][j][2 * hf],
              acc[mt][j][2 * hf + 1]);
}

// The rows of a pass (PASS_ROWS, or `rows`), cols (a multiple of 8) from
// shared memory (src, leading dim lds) to the block's operand rows in
// device memory (dst, leading dim ldd), 16 bytes a copy, for wgrad_block.
// Block-wide, without a barrier.
__device__ __forceinline__ void save_rows(bf16* dst, int ldd, const bf16* src,
                                          int lds, int cols,
                                          int rows = PASS_ROWS) {
  const int cpr = cols / 8;
  for (int i = threadIdx.x; i < rows * cpr; i += NTHREADS) {
    const int r = i / cpr, c = (i - r * cpr) * 8;
    *reinterpret_cast<uint4*>(dst + (size_t)r * ldd + c) =
        *reinterpret_cast<const uint4*>(src + r * lds + c);
  }
}

// A weight gradient over the `rows` operand rows a block saved
// (save_rows; a multiple of 16): gW[k, n] = sum_r a[r, k] b[r, n] for
// k < K, n < N (multiples of 16) into this block's float32 slice gW
// (leading dim ldg), and gb[n] = sum_r b[r, n] in row order when gb is
// not null; a and b point at their first column in the operand rows
// (leading dim ld).  The rows are staged through shared memory (smem,
// `elems` bf16) in chunks of as many as it holds, and the mma tiles'
// sums over a chunk are stored into the slice, or added to it after the
// first chunk: where one chunk holds every row, each slice element is
// written once and never read.  A warp's item is 16 rows of gW by NJ x 16
// columns (N a multiple of 16 NJ): NJ independent sums over the rows for
// one A fragment a step, where NJ = 1 leaves a warp one dependent chain.
// Block-wide; ends with a barrier.
template <int NJ = 1>
__device__ __forceinline__ void wgrad_block(const bf16* a, const bf16* b,
                                            int ld, int rows, int K, int N,
                                            float* gW, int ldg, float* gb,
                                            bf16* smem, int elems) {
  constexpr int NW = NTHREADS / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lda = K + 8, ldb = N + 8, cpa = K / 8, cpr = (K + N) / 8;
  const int chunk = elems / (lda + ldb) / 16 * 16;
  const int tn = N / (16 * NJ), tiles = (K / 16) * tn;
  for (int r0 = 0; r0 < rows; r0 += chunk) {
    const int nr = rows - r0 < chunk ? rows - r0 : chunk;
    bf16* sb = smem + nr * lda;
    for (int i = threadIdx.x; i < nr * cpr; i += NTHREADS) {
      const int r = i / cpr, c = i - r * cpr;
      if (c < cpa)
        cp_async_16(smem + r * lda + 8 * c, a + (size_t)(r0 + r) * ld + 8 * c);
      else
        cp_async_16(sb + r * ldb + 8 * (c - cpa),
                    b + (size_t)(r0 + r) * ld + 8 * (c - cpa));
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int tile = warp; tile < tiles; tile += NW) {
      const int m0 = (tile / tn) * 16;
      const int n0 = (tile - (tile / tn) * tn) * 16 * NJ;
      float acc[NJ][2][4] = {};
      for (int ks = 0; ks < nr / 16; ++ks) {
        unsigned af[4];
        load_a_t(af, smem + ks * 16 * lda + m0, lda, lane);
#pragma unroll
        for (int nj = 0; nj < NJ; ++nj) {
          unsigned bf[4];
          load_b_kn(bf, sb + ks * 16 * ldb + n0 + 16 * nj, ldb, lane);
          mma_bf16_16816(acc[nj][0], af, bf);
          mma_bf16_16816(acc[nj][1], af, bf + 2);
        }
      }
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj) {
        float* p = gW + (m0 + g) * ldg + n0 + 16 * nj + 2 * t;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float* q = p + (e >> 1) * 8 * ldg + 8 * j + (e & 1);
            *q = r0 ? *q + acc[nj][j][e] : acc[nj][j][e];
          }
      }
    }
    if (gb != nullptr)
      for (int n = threadIdx.x; n < N; n += NTHREADS) {
        float sum = 0.f;
        for (int r = 0; r < nr; ++r) sum += to_f<bf16>(sb[r * ldb + n]);
        gb[n] = r0 ? gb[n] + sum : sum;
      }
    __syncthreads();
  }
}

// A weight gradient of K = 192 rows over `rows` operand rows (a multiple
// of 16) saved in device memory: gW[k, n] = sum_r a[r, k] b[r, n] for n <
// N (a multiple of 96) into gW (leading dim ldg), and gb[n] = sum_r b[r,
// n] when gb is not null; a and b point at their first column in the
// operand rows (leading dim ld).  96 columns at a time, whose sums stay in
// registers (warp w the 48 x 48 tile of gW at row 48 (w >> 1), column 48
// (w & 1): three 16-column tiles of three independent sums a step) while
// every row streams through a ring of three WG_ROWS-row chunks of shared
// memory (smem: WG_SMEM bf16) by cp.async, one barrier a chunk; then each
// element is stored once, never read, so the slice needs no zeroing.  The
// bias as the product with a tile of ones (warps 0 and 1).  Against
// wgrad_block, which stores each chunk's sums and adds the next chunk's to
// them through device memory, one warp item a 16 x 16 tile, no element is
// read back.  Block-wide; ends with a barrier.
constexpr int WG_ROWS = 64, WG_LDA = 192 + 8, WG_LDB = 96 + 8;
constexpr int WG_STAGE = WG_ROWS * (WG_LDA + WG_LDB);
constexpr int WG_SMEM = 3 * WG_STAGE;
__device__ __forceinline__ void wgrad_stream(const bf16* a, const bf16* b,
                                             int ld, int rows, int N,
                                             float* gW, int ldg, float* gb,
                                             bf16* smem) {
  constexpr int STAGES = 3;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = 48 * (warp >> 1), n0 = 48 * (warp & 1);
  const int nch = (rows + WG_ROWS - 1) / WG_ROWS, total = nch * (N / 96);
  const bool bias = gb != nullptr && warp < 2;
  // chunk i: rows WG_ROWS (i % nch).. of a's 192 columns and b's 96 of
  // block i / nch, into stage i % STAGES; an empty group past the last
  auto issue = [&](int i) {
    if (i < total) {
      const int blk = i / nch, r0 = (i - blk * nch) * WG_ROWS;
      const int nr = rows - r0 < WG_ROWS ? rows - r0 : WG_ROWS;
      bf16* sa = smem + (i % STAGES) * WG_STAGE;
      bf16* sb = sa + WG_ROWS * WG_LDA;
      const bf16* ar = a + (size_t)r0 * ld;
      const bf16* br = b + (size_t)r0 * ld + 96 * blk;
      for (int e = threadIdx.x; e < nr * 36; e += NTHREADS) {
        const int r = e / 36, c = e - r * 36;
        if (c < 24)
          cp_async_16(sa + r * WG_LDA + 8 * c, ar + (size_t)r * ld + 8 * c);
        else
          cp_async_16(sb + r * WG_LDB + 8 * (c - 24),
                      br + (size_t)r * ld + 8 * (c - 24));
      }
    }
    cp_async_commit();
  };
  float acc[3][3][2][4], bacc[3][2][4];
  auto zero = [&] {
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][h][e] = 0.f;
          if (i == 0)
#pragma unroll
            for (int e = 0; e < 4; ++e) bacc[j][h][e] = 0.f;
        }
  };
  zero();
  const unsigned ones[4] = {0x3F803F80u, 0x3F803F80u, 0x3F803F80u,
                            0x3F803F80u};   // a tile of bf16 ones
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) issue(i);
  for (int i = 0; i < total; ++i) {
    cp_async_wait<STAGES - 2>();   // chunk i has landed
    __syncthreads();               // every warp is past chunk i - 1
    issue(i + STAGES - 1);
    const int blk = i / nch, ch = i - blk * nch;
    const int nr = rows - ch * WG_ROWS < WG_ROWS ? rows - ch * WG_ROWS
                                                 : WG_ROWS;
    const bf16* sa = smem + (i % STAGES) * WG_STAGE;
    const bf16* sb = sa + WG_ROWS * WG_LDA;
    for (int ks = 0; ks < nr / 16; ++ks) {
      unsigned af[3][4], bf[3][4];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        load_a_t(af[k], sa + ks * 16 * WG_LDA + m0 + 16 * k, WG_LDA, lane);
        load_b_kn(bf[k], sb + ks * 16 * WG_LDB + n0 + 16 * k, WG_LDB, lane);
      }
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          mma_bf16_16816(acc[k][j][0], af[k], bf[j]);
          mma_bf16_16816(acc[k][j][1], af[k], bf[j] + 2);
        }
      if (bias)
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          mma_bf16_16816(bacc[j][0], ones, bf[j]);
          mma_bf16_16816(bacc[j][1], ones, bf[j] + 2);
        }
    }
    if (ch == nch - 1) {           // block blk's sums are whole:
      const int nb = 96 * blk + n0;  // stored a pair of columns at once
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int j = 0; j < 3; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf)
              *reinterpret_cast<float2*>(
                  gW + (m0 + 16 * k + g + 8 * hf) * ldg + nb + 16 * j +
                  8 * h + 2 * t) =
                  float2{acc[k][j][h][2 * hf], acc[k][j][h][2 * hf + 1]};
      if (bias && g == 0)
#pragma unroll
        for (int j = 0; j < 3; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<float2*>(gb + nb + 16 * j + 8 * h + 2 * t) =
                float2{bacc[j][h][0], bacc[j][h][1]};
      zero();
    }
  }
  __syncthreads();
}

// The block-wide sums of every thread's v[k] (k < NV), in a fixed order
// (the lanes by shuffles, then the warps in turn), left in red[8 NV + k]
// for every thread; red: 9 NV floats.  Block-wide.
template <int NV>
__device__ __forceinline__ void block_sums(float (&v)[NV], float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      v[k] += __shfl_xor_sync(0xffffffffu, v[k], o);
    if (lane == 0) red[warp * NV + k] = v[k];
  }
  __syncthreads();
  if ((int)threadIdx.x < NV) {
    float s = 0.f;
    for (int w = 0; w < NTHREADS / 32; ++w) s += red[w * NV + threadIdx.x];
    red[8 * NV + threadIdx.x] = s;
  }
  __syncthreads();
}

// The LayerNorm backward of ROWS bf16 rows of COLS columns (ln_rows' form;
// its statistics recomputed from x in float32, as layer_norm_bwd_rows
// does): dx = rstd (g - mean(g) - xhat mean(g xhat)) with g = dy scale,
// the last term dropped where the variance clamps at 0, plus add[r, c]
// when add is not null, rounded to bf16 (dx may be dy; every leading dim
// ld).  The scale and bias gradients, sums over the rows in row order,
// are added to gs, gb (this block's slice).  Eight lanes share a row, as
// in ln_rows.  stats: 4 ROWS floats.  Block-wide; ends with a barrier.
template <int ROWS, int COLS>
__device__ __forceinline__ void ln_bwd_rows(const bf16* x, const bf16* dy,
                                            bf16* dx, const bf16* add, int ld,
                                            const float* scale, float* gs,
                                            float* gb, float* stats) {
  constexpr int P = COLS / 16;
  constexpr int R = ROWS / (NTHREADS / 8);
  static_assert(P * 16 == COLS && R * (NTHREADS / 8) == ROWS,
                "whole column pairs and rows per thread");
  const int sub = threadIdx.x >> 3, c0 = 2 * (threadIdx.x & 7);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = sub + i * (NTHREADS / 8);
    float xv[2 * P], gv[2 * P], s = 0.f, sq = 0.f;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const int c = row * ld + c0 + 16 * k;
      const unsigned ux = *reinterpret_cast<const unsigned*>(x + c);
      const unsigned ud = *reinterpret_cast<const unsigned*>(dy + c);
      xv[2 * k] = bf16x2_lo(ux);
      xv[2 * k + 1] = bf16x2_hi(ux);
      gv[2 * k] = bf16x2_lo(ud) * scale[c0 + 16 * k];
      gv[2 * k + 1] = bf16x2_hi(ud) * scale[c0 + 16 * k + 1];
      s += xv[2 * k] + xv[2 * k + 1];
      sq += xv[2 * k] * xv[2 * k] + xv[2 * k + 1] * xv[2 * k + 1];
    }
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      sq += __shfl_xor_sync(0xffffffffu, sq, o);
    }
    const float mu = s / COLS, vraw = sq / COLS - mu * mu;
    const float rs = rsqrtf(fmaxf(vraw, 0.f) + LN_EPS);
    float ga = 0.f, gb2 = 0.f;
#pragma unroll
    for (int k = 0; k < 2 * P; ++k) {
      ga += gv[k];
      gb2 += gv[k] * (xv[k] - mu) * rs;
    }
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) {
      ga += __shfl_xor_sync(0xffffffffu, ga, o);
      gb2 += __shfl_xor_sync(0xffffffffu, gb2, o);
    }
    if ((threadIdx.x & 7) == 0) {
      stats[4 * row] = mu;
      stats[4 * row + 1] = rs;
      stats[4 * row + 2] = ga / COLS;
      stats[4 * row + 3] = vraw >= 0.f ? gb2 / COLS : 0.f;
    }
  }
  __syncthreads();
  if (gs != nullptr)
    for (int c = threadIdx.x; c < COLS; c += NTHREADS) {
      float ss = 0.f, sb = 0.f;
      for (int r = 0; r < ROWS; ++r) {
        const float d = to_f<bf16>(dy[r * ld + c]);
        ss += d * ((to_f<bf16>(x[r * ld + c]) - stats[4 * r]) *
                   stats[4 * r + 1]);
        sb += d;
      }
      gs[c] += ss;
      gb[c] += sb;
    }
  __syncthreads();        // dx may overwrite dy
  for (int i = threadIdx.x; i < ROWS * COLS / 2; i += NTHREADS) {
    const int r = i / (COLS / 2), c = 2 * (i - r * (COLS / 2));
    const float* st = stats + 4 * r;
    float v[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float xh = (to_f<bf16>(x[r * ld + c + e]) - st[0]) * st[1];
      const float gg = to_f<bf16>(dy[r * ld + c + e]) * scale[c + e];
      v[e] = st[1] * (gg - st[2] - xh * st[3]);
      if (add != nullptr) v[e] += to_f<bf16>(add[r * ld + c + e]);
    }
    store_bf16x2(dx + r * ld + c, pack_bf16x2(v[0], v[1]));
  }
  __syncthreads();
}

// The attention dropout of one warp's probabilities in head vh of one
// sample (identity unless dr.on): element (query row, key) has the flat
// index base + (vh * nq + row) * kv + key, as common.cuh's attention
// numbers it (nq: the queries of a head, the sample's tokens; at n = 64
// base also holds the warp's first query row times kv), and keeps
// rnd(p / keep) or 0.
struct AttnMask {
  Drop dr;
  unsigned base;
  int vh, kv;
  int nq = NT;
};

__device__ __forceinline__ float attn_mask(const AttnMask& m, int row,
                                           int key, float p) {
  if (!m.dr.on) return p;
  return kept(m.dr.salt, m.dr.thr,
              m.base + (unsigned)((m.vh * m.nq + row) * m.kv + key))
             ? p / m.dr.keep
             : 0.f;
}

// attn_mask with a kept probability scaled by the product with inv_keep
// (1 / m.dr.keep) instead of the quotient: within an ulp of it, and no
// IEEE division an element (the n = 64 CGA backward)
__device__ __forceinline__ float attn_mask_r(const AttnMask& m, int row,
                                             int key, float p,
                                             float inv_keep) {
  if (!m.dr.on) return p;
  return kept(m.dr.salt, m.dr.thr,
              m.base + (unsigned)((m.vh * m.nq + row) * m.kv + key))
             ? p * inv_keep
             : 0.f;
}

// The float32 softmax of one warp's scores of 16 queries over NKT tiles of
// 16 keys, in place in the C-fragment layout (s[j] holds keys 8j.. of
// query rows g and g + 8): each score divided by sqrt_d as common.cuh's
// attention divides it, keys from nkeys on -inf, the rows' maxima and
// sums by quad shuffles.  RECIP: each exp times the reciprocal of its
// row's sum (one float32 rounding more than the division, and no IEEE
// division a score: the CGA kernels' 4-wide heads spend their time there).
template <int NKT, bool RECIP = false>
__device__ __forceinline__ void softmax_c(float (&s)[2 * NKT][4], int nkeys,
                                          float sqrt_d) {
  const int t = threadIdx.x & 3;
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < 2 * NKT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool in = 8 * j + 2 * t + e < nkeys;
      s[j][e] = in ? s[j][e] / sqrt_d : -INFINITY;
      s[j][2 + e] = in ? s[j][2 + e] / sqrt_d : -INFINITY;
      m0 = fmaxf(m0, s[j][e]);
      m1 = fmaxf(m1, s[j][2 + e]);
    }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
  }
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int j = 0; j < 2 * NKT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[j][e] = expf(s[j][e] - m0);
      s[j][2 + e] = expf(s[j][2 + e] - m1);
      l0 += s[j][e];
      l1 += s[j][2 + e];
    }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }
  if constexpr (RECIP) {
    l0 = 1.f / l0;
    l1 = 1.f / l1;
  }
#pragma unroll
  for (int j = 0; j < 2 * NKT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if constexpr (RECIP) {
        s[j][e] *= l0;
        s[j][2 + e] *= l1;
      } else {
        s[j][e] = s[j][e] / l0;
        s[j][2 + e] = s[j][2 + e] / l1;
      }
    }
}

// One warp's softmax probabilities of 16 queries in one head over NKT
// tiles of 16 keys, as warp_attention computes them (scores divided by
// sqrt(D), keys from nkeys on -inf, float32 softmax by quad shuffles),
// left in s in the C-fragment layout: s[j] holds keys 8j.. of query rows
// g and g + 8.
template <int NKT, bool RECIP = false>
__device__ __forceinline__ void attn_probs(const unsigned (&qa)[3][4],
                                           const bf16* const (&kt)[NKT],
                                           int ld, int hc, int nkeys,
                                           float (&s)[2 * NKT][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 2 * NKT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < ATT_D / 16; ++ks)
#pragma unroll
    for (int np = 0; np < NKT; ++np) {
      unsigned kb[4];
      load_b_nk(kb, kt[np] + hc + ks * 16, ld, lane);
      mma_bf16_16816(s[2 * np], qa[ks], kb);
      mma_bf16_16816(s[2 * np + 1], qa[ks], kb + 2);
    }
  softmax_c<NKT, RECIP>(s, nkeys, sqrtf((float)ATT_D));
}

// The A fragments of a 16-key step kk of probabilities (or dS) held in
// C fragments s, each value through f(row, key, value) and rounded to
// bf16: two neighbouring C tiles are one A fragment (mma.cuh)
template <int NKT, typename F>
__device__ __forceinline__ void c_to_a(const float (&s)[2 * NKT][4], int kk,
                                       F&& f, unsigned (&pa)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = 2 * kk + (r >> 1), hf = r & 1;
    const int key = 8 * j + 2 * t, row = g + 8 * hf;
    pa[r] = pack_bf16x2(f(row, key, s[j][2 * hf]),
                        f(row, key + 1, s[j][2 * hf + 1]));
  }
}

// warp_attention in training: the probabilities through the attention
// dropout m before PV (rnd(P / keep) or 0, as common.cuh's attention),
// the 16 output rows to out (leading dim ldo, columns hc..) as bf16.
// True if an output is NaN.  RECIP (the n = 64 SWA and MSDA backwards):
// each row's softmax as the product with its sum's reciprocal
// (softmax_c) and the dropout scale as the product with 1 / keep
// (attn_mask_r), each within an ulp of the quotient, no IEEE division a
// probability.  In two halves: attn_probs, then attn_pv_train from the
// probabilities s, which a caller may keep for attn_bwd_p.
template <int NKT, bool RECIP = false>
__device__ __forceinline__ bool attn_pv_train(
    const float (&s)[2 * NKT][4], const bf16* const (&vt)[NKT], int ld,
    int hc, const AttnMask& m, bf16* out, int ldo) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float inv_keep = 1.f / m.dr.keep;
  float o[6][4];
#pragma unroll
  for (int j = 0; j < 6; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < NKT; ++kk) {
    unsigned pa[4];
    c_to_a<NKT>(s, kk, [&](int row, int key, float p) {
      if constexpr (RECIP) return attn_mask_r(m, row, key, p, inv_keep);
      return attn_mask(m, row, key, p);
    }, pa);
#pragma unroll
    for (int dp = 0; dp < ATT_D / 16; ++dp) {
      unsigned vb[4];
      load_b_kn(vb, vt[kk] + hc + dp * 16, ld, lane);
      mma_bf16_16816(o[2 * dp], pa, vb);
      mma_bf16_16816(o[2 * dp + 1], pa, vb + 2);
    }
  }
  bool nan_seen = false;
#pragma unroll
  for (int j = 0; j < 6; ++j)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float x0 = o[j][2 * hf], x1 = o[j][2 * hf + 1];
      nan_seen = nan_seen || isnan(x0) || isnan(x1);
      store_bf16x2(out + (g + 8 * hf) * ldo + hc + 8 * j + 2 * t,
                   pack_bf16x2(x0, x1));
    }
  return nan_seen;
}

template <int NKT, bool RECIP = false>
__device__ __forceinline__ bool warp_attention_train(
    const unsigned (&qa)[3][4], const bf16* const (&kt)[NKT],
    const bf16* const (&vt)[NKT], int ld, int hc, int nkeys,
    const AttnMask& m, bf16* out, int ldo) {
  float s[2 * NKT][4];
  attn_probs<NKT, RECIP>(qa, kt, ld, hc, nkeys, s);
  return attn_pv_train<NKT, RECIP>(s, vt, ld, hc, m, out, ldo);
}

// The backward of warp_attention_train for one warp's 16 queries in one
// head, given the output's cotangent dO (16 rows, leading dim ldo,
// columns hc..): P recomputed from q (qa), the keys and the mask; dP = dO
// V^T through the mask; dS = P (dP - rowsum(dP P)) / sqrt(D), the
// division placed as common.cuh's attention_bwd places it; dq = dS K
// (dS rounded to bf16 straight into A fragments) to dq (leading dim
// lddq, columns hc..).  dS and the probabilities PV used go to ds and pu
// (16 rows, keys 0 .. 16 NKT, leading dim lds), all as bf16, for the key
// gradients dK = dS^T q and dV = P^T dO, which the caller forms (mma_tn)
// after a __syncwarp (one sample's keys) or a barrier (keys shared by
// the samples).  Keys past nkeys must be finite rows (zeros).  RECIP as
// warp_attention_train's, and each element's mask bit hashed once for dP
// and the P used, dS scaled by the product with 1 / sqrt(D).  In two
// halves: attn_probs, then attn_bwd_p from the probabilities s (which it
// overwrites with dS), so a caller that kept the forward's s skips the
// recompute.
template <int NKT, bool RECIP = false>
__device__ __forceinline__ void attn_bwd_p(
    float (&s)[2 * NKT][4], const bf16* const (&kt)[NKT],
    const bf16* const (&vt)[NKT], int ld, int hc, const AttnMask& m,
    const bf16* dO, int ldo, bf16* dq, int lddq, bf16* ds, bf16* pu,
    int lds) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float sqrt_d = sqrtf((float)ATT_D);
  float dp[2 * NKT][4];
  unsigned oa[3][4];
#pragma unroll
  for (int ks = 0; ks < 3; ++ks) load_a(oa[ks], dO + hc + ks * 16, ldo, lane);
#pragma unroll
  for (int j = 0; j < 2 * NKT; ++j)
    dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < 3; ++ks)
#pragma unroll
    for (int np = 0; np < NKT; ++np) {
      unsigned vb[4];
      load_b_nk(vb, vt[np] + hc + ks * 16, ld, lane);
      mma_bf16_16816(dp[2 * np], oa[ks], vb);
      mma_bf16_16816(dp[2 * np + 1], oa[ks], vb + 2);
    }
  float dot0 = 0.f, dot1 = 0.f;
  if constexpr (RECIP) {
    const float inv_keep = 1.f / m.dr.keep;
#pragma unroll
    for (int j = 0; j < 2 * NKT; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int key = 8 * j + 2 * t, row = g + 8 * hf;
        float mk[2];               // the mask's scale: 1, 1 / keep or 0
#pragma unroll
        for (int e = 0; e < 2; ++e)
          mk[e] = !m.dr.on ? 1.f
                  : kept(m.dr.salt, m.dr.thr,
                         m.base + (unsigned)((m.vh * m.nq + row) * m.kv +
                                             key + e))
                      ? inv_keep
                      : 0.f;
        // the probabilities PV used, for dV
        store_bf16x2(pu + row * lds + key,
                     pack_bf16x2(s[j][2 * hf] * mk[0],
                                 s[j][2 * hf + 1] * mk[1]));
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          dp[j][2 * hf + e] *= mk[e];
          if (hf)
            dot1 = fmaf(dp[j][2 + e], s[j][2 + e], dot1);
          else
            dot0 = fmaf(dp[j][e], s[j][e], dot0);
        }
      }
  } else {
#pragma unroll
    for (int j = 0; j < 2 * NKT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = 8 * j + 2 * t + (e & 1), row = g + 8 * (e >> 1);
        dp[j][e] = attn_mask(m, row, key, dp[j][e]);
        // the probabilities PV used, for dV
        if (e & 1)
          store_bf16x2(pu + row * lds + key - 1,
                       pack_bf16x2(attn_mask(m, row, key - 1, s[j][e - 1]),
                                   attn_mask(m, row, key, s[j][e])));
        if (e >> 1)
          dot1 = fmaf(dp[j][e], s[j][e], dot1);
        else
          dot0 = fmaf(dp[j][e], s[j][e], dot0);
      }
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    dot0 += __shfl_xor_sync(0xffffffffu, dot0, o);
    dot1 += __shfl_xor_sync(0xffffffffu, dot1, o);
  }
  const float inv_sqrt_d = 1.f / sqrt_d;
#pragma unroll
  for (int j = 0; j < 2 * NKT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float v = s[j][e] * (dp[j][e] - (e >> 1 ? dot1 : dot0));
      s[j][e] = RECIP ? v * inv_sqrt_d : v / sqrt_d;
    }
#pragma unroll
  for (int j = 0; j < 2 * NKT; ++j)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      store_bf16x2(ds + (g + 8 * hf) * lds + 8 * j + 2 * t,
                   pack_bf16x2(s[j][2 * hf], s[j][2 * hf + 1]));
  float o[6][4];
#pragma unroll
  for (int j = 0; j < 6; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < NKT; ++kk) {
    unsigned da[4];
    c_to_a<NKT>(s, kk, [](int, int, float v) { return v; }, da);
#pragma unroll
    for (int dp16 = 0; dp16 < ATT_D / 16; ++dp16) {
      unsigned kb[4];
      load_b_kn(kb, kt[kk] + hc + dp16 * 16, ld, lane);
      mma_bf16_16816(o[2 * dp16], da, kb);
      mma_bf16_16816(o[2 * dp16 + 1], da, kb + 2);
    }
  }
#pragma unroll
  for (int j = 0; j < 6; ++j)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      store_bf16x2(dq + (g + 8 * hf) * lddq + hc + 8 * j + 2 * t,
                   pack_bf16x2(o[j][2 * hf], o[j][2 * hf + 1]));
}

template <int NKT, bool RECIP = false>
__device__ __forceinline__ void warp_attention_bwd(
    const unsigned (&qa)[3][4], const bf16* const (&kt)[NKT],
    const bf16* const (&vt)[NKT], int ld, int hc, int nkeys,
    const AttnMask& m, const bf16* dO, int ldo, bf16* dq, int lddq,
    bf16* ds, bf16* pu, int lds) {
  float s[2 * NKT][4];
  attn_probs<NKT, RECIP>(qa, kt, ld, hc, nkeys, s);
  attn_bwd_p<NKT, RECIP>(s, kt, vt, ld, hc, m, dO, ldo, dq, lddq, ds, pu,
                         lds);
}

// The key gradients of warp_attention_bwd for 16 keys and one head of
// ATT_D columns: acc[c][.] += the 16 x 16 tile c of A^T B over 16 KS rows,
// A = dS or P (keys from a's column pointer), B = q or dO (head columns
// from b's pointer)
template <int KS>
__device__ __forceinline__ void key_grads(const bf16* a, int lda,
                                          const bf16* b, int ldb,
                                          float (&acc)[ATT_D / 16][2][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int c = 0; c < ATT_D / 16; ++c) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
      acc[c][j][0] = acc[c][j][1] = acc[c][j][2] = acc[c][j][3] = 0.f;
    mma_tn<KS>(acc[c], a, lda, b + 16 * c, ldb, lane);
  }
}

}  // namespace qv
