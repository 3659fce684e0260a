// The pieces the n = 64 train-mode SWA and MSDA forwards on two-CTA
// clusters share (swa_train64_kernel in unit_swa_train64.cu,
// msda_train64_kernel in unit_msda_train64.cu): a cluster takes a sample
// at a time, each CTA half its 64 rows, and the bank-write partials of a
// sample span the pair, since the gate's softmax runs over the sample's
// 64 tokens.  A CTA forms t and the gate's logits of its own 32 rows (as
// bank_tile_partials in mma_ops.cuh), the pair exchanges each bank row's
// maximum and its sum of exponentials through distributed shared memory
// between cluster barriers, and each CTA adds its rows' gated t to its
// part_v.  At the end the pair sums its part_v and gate sums in rank
// order (pair_sums) into the cluster's slice, part_k left to the pass
// after the reduction (qv_bank_compress).
#pragma once
#include "cluster.cuh"
#include "window_mma.cuh"

namespace qv {

constexpr int WT_ROWS = BP_ROWS / 2;     // a CTA's rows of a sample
// the pair partials' scratch, floats: t [32][BP_LDT], gate [32][BP_S],
// the gate's kernel [C][BP_S]
constexpr int WT_SCRATCH = WT_ROWS * (BP_LDT + BP_S) + BP_C * BP_S;
// the gate exchange, floats: two buffers (a call's parity), each its
// bank rows' maxima, then their sums of exponentials
constexpr int WT_XCH = 2 * 2 * BP_S;

// four floats rounded to bf16 at dst, dst + step, ..; true if one is NaN
__device__ __forceinline__ bool put4(bf16* dst, int step, float4 v) {
  const float r[4] = {rnd<bf16>(v.x), rnd<bf16>(v.y), rnd<bf16>(v.z),
                      rnd<bf16>(v.w)};
#pragma unroll
  for (int j = 0; j < 4; ++j) dst[j * step] = from_f<bf16>(r[j]);
  return isnan(r[0]) || isnan(r[1]) || isnan(r[2]) || isnan(r[3]);
}

// The warp's q of one head (ring_gemm<1, 6>: 16 rows x the ATT_D
// columns from hc) with its dense epilogue, rounded straight into the A
// fragments qa[16-column step] of the score product (q_fragments' form
// for one head); true if a q is NaN.
__device__ __forceinline__ bool q_head_fragments(float (&acc)[1][6][4],
                                                 const float* bias, int hc,
                                                 unsigned (&qa)[3][4]) {
  const int t = threadIdx.x & 3;
  bool nan_seen = false;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    const int col = hc + 8 * j + 2 * t;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[0][j][e] = dense_out(acc[0][j][e], bias[col + (e & 1)]);
      nan_seen = nan_seen || isnan(acc[0][j][e]);
    }
  }
#pragma unroll
  for (int ks = 0; ks < 3; ++ks) {
    const float* c0 = acc[0][2 * ks];
    const float* c1 = acc[0][2 * ks + 1];
    qa[ks][0] = pack_bf16x2(c0[0], c0[1]);
    qa[ks][1] = pack_bf16x2(c0[2], c0[3]);
    qa[ks][2] = pack_bf16x2(c1[0], c1[1]);
    qa[ks][3] = pack_bf16x2(c1[2], c1[3]);
  }
  return nan_seen;
}

// The bank rows k, v [S, C] rounded into bk, bv (leading dim ld, rows
// past S zero), a thread's float4 loads all in flight; true if one is
// NaN.  Block-wide, without a barrier.
__device__ __forceinline__ bool stage_bank(const float* bank_k,
                                           const float* bank_v, int S,
                                           bf16* bk, bf16* bv, int ld) {
  constexpr int N4 = BP_S * BP_C / 4;
  static_assert(N4 % NTHREADS == 0, "whole rounds of the block's threads");
  const float4 zero4{0.f, 0.f, 0.f, 0.f};
  bool nan_seen = false;
#pragma unroll
  for (int k = 0; k < N4 / NTHREADS; ++k) {
    const int i = threadIdx.x + k * NTHREADS;
    const int r = 4 * i / BP_C, c = 4 * i - r * BP_C;
    const float4 vk =
        r < S ? reinterpret_cast<const float4*>(bank_k)[i] : zero4;
    const float4 vv =
        r < S ? reinterpret_cast<const float4*>(bank_v)[i] : zero4;
    nan_seen |= put4(bk + r * ld + c, 1, vk);
    nan_seen |= put4(bv + r * ld + c, 1, vv);
  }
  return nan_seen;
}
static_assert(2 * BP_S * BP_C + BP_S <= WT_SCRATCH,
              "the pair sums in the partials' scratch");
static_assert(WT_ROWS == 32 && NTHREADS == 8 * WT_ROWS,
              "a lane a row in the exchange; eight lanes a row for t");

// The bank-write partials of this CTA's WT_ROWS rows of one sample (bf16
// `out`, leading dim ld), the partner holding the sample's other rows,
// added to acc: t = LN(rnd(LN(out; the branch's norm)); write_norm) with
// jnp.var's two-pass variance, the gate's logits t @ Wg + bg, and the
// gate's softmax over the sample's 64 tokens: each CTA leaves its rows'
// maximum m_r and sum s_r of exp(logit - m_r) for each bank row in xch
// (the buffer of `parity`), and after a cluster barrier both take M =
// max(m_0, m_1) and the sum s_0 exp(m_0 - M) + s_1 exp(m_1 - M) in rank
// order, so that the pair's gates are the same numbers.  Both CTAs call
// it for the same sample, with parity alternating from call to call:
// this CTA rewrites a buffer only after the next call's barrier, by which
// the partner has read it.  The gate's kernel comes by cp.async while t
// is formed (its wait completes every copy committed before).  stamp()
// is called once the logits are formed (a phase stamp).  scratch:
// WT_SCRATCH floats.  Block-wide and a cluster barrier; ends with a block
// barrier.
template <typename F>
__device__ __forceinline__ void bank_pair_partials(const bf16* out, int ld,
                                                   const BankWrite& bw,
                                                   int S, float* scratch,
                                                   float* xch, int parity,
                                                   BankSums& acc, F&& stamp) {
  constexpr int P = BP_C / 16;             // column pairs of a lane
  float* t = scratch;
  float* gate = t + WT_ROWS * BP_LDT;
  float* wg = gate + WT_ROWS * BP_S;       // [C][BP_S], zero past S
  if (S % 4 == 0) {                        // rows of whole 16-byte copies
    for (int i = threadIdx.x; i < BP_C * BP_S / 4; i += NTHREADS) {
      const int k = i / (BP_S / 4), j = 4 * (i - k * (BP_S / 4));
      if (j < S)
        cp_async_16(wg + k * BP_S + j, bw.gate_w + k * S + j);
      else
        *reinterpret_cast<float4*>(wg + k * BP_S + j) =
            float4{0.f, 0.f, 0.f, 0.f};
    }
    cp_async_commit();
  } else {
    for (int i = threadIdx.x; i < BP_C * BP_S; i += NTHREADS) {
      const int k = i / BP_S, m = i - k * BP_S;
      wg[i] = m < S ? bw.gate_w[k * S + m] : 0.f;
    }
  }
  {  // t of every row, eight lanes a row (as ln_rows), a row a thread
    const int r = threadIdx.x >> 3, c0 = 2 * (threadIdx.x & 7);
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
  cp_async_wait<0>();
  __syncthreads();
  {  // the gate's logits: thread (row, two of the 16 columns; zero past S)
    const int r = threadIdx.x >> 3, m0 = 2 * (threadIdx.x & 7);
    float a0 = 0.f, a1 = 0.f;
#pragma unroll 4
    for (int k = 0; k < BP_C; ++k) {
      const float tv = t[r * BP_LDT + k];
      const float2 w = *reinterpret_cast<const float2*>(wg + k * BP_S + m0);
      a0 = fmaf(tv, w.x, a0);
      a1 = fmaf(tv, w.y, a1);
    }
    gate[r * BP_S + m0] = m0 < S ? a0 + bw.gate_b[m0] : 0.f;
    gate[r * BP_S + m0 + 1] = m0 + 1 < S ? a1 + bw.gate_b[m0 + 1] : 0.f;
  }
  __syncthreads();
  stamp();
  // a warp a bank row, a lane a row: this CTA's maximum and sum
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* mine = xch + parity * 2 * BP_S;   // [BP_S] maxima, [BP_S] sums
  for (int m = warp; m < S; m += NTHREADS / 32) {
    const float v = gate[lane * BP_S + m];
    float mx = v;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = expf(v - mx);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) {
      mine[m] = mx;
      mine[BP_S + m] = sum;
    }
  }
  cluster_sync();          // both CTAs' maxima and sums are written
  {
    const unsigned rank = cluster_rank();
    const float* peer = cluster_peer(mine, rank ^ 1u);
    const float* r0 = rank ? peer : mine;
    const float* r1 = rank ? mine : peer;
    for (int m = warp; m < S; m += NTHREADS / 32) {
      const float mx = fmaxf(r0[m], r1[m]);
      const float sum = r0[BP_S + m] * expf(r0[m] - mx) +
                        r1[BP_S + m] * expf(r1[m] - mx);
      float* gp = gate + lane * BP_S + m;
      *gp = expf(*gp - mx) / sum;
    }
  }
  __syncthreads();
  if ((int)threadIdx.x < BP_C) {   // part_v of column c, every bank row
    const int c = threadIdx.x;
    for (int r = 0; r < WT_ROWS; ++r) {
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
    for (int r = 0; r < WT_ROWS; ++r) acc.gate += gate[r * BP_S + threadIdx.x];
  __syncthreads();
}

// The cluster's slice `part` [2, S, C] of the per-cluster sums for
// qv_bank_compress (bank_store_sums' layout: part_v, and in part_k's
// place each bank row's gate sum in every column): both CTAs' sums added
// in rank order, every field stored once, half by each CTA (pair_sums).
// scratch: WT_SCRATCH floats, which the partner reads until its next
// cluster arrival after this call: the caller's (a cluster barrier, or
// finish_guard_pair's) before scratch is rewritten or the CTA exits.
// Both CTAs call it; a cluster barrier.
__device__ __forceinline__ void bank_pair_store(const BankSums& acc, int S,
                                                float* scratch, float* part) {
  float* sums = scratch;                   // [2][S][C], the slice's layout
  float* gs = scratch + 2 * S * BP_C;
  const int c = threadIdx.x;
  if (c < S) gs[c] = acc.gate;
  __syncthreads();
  if (c < BP_C)
#pragma unroll
    for (int m = 0; m < BP_S; ++m)
      if (m < S) {
        sums[m * BP_C + c] = gs[m];
        sums[S * BP_C + m * BP_C + c] = acc.v[m];
      }
  cluster_sync();          // both CTAs' sums are written
  pair_sums(sums, 2 * S * BP_C, [&](int i, float v) { part[i] = v; });
}

// The guard's redo: every cluster's slice of the partials but this one's
// zero (this cluster's sums the whole batch's), half by each CTA.
__device__ __forceinline__ void zero_other_slices(float* part, int slices,
                                                  int S) {
  const int n = 2 * S * BP_C, mine = (int)blockIdx.x / 2;
  for (int i = threadIdx.x + (int)cluster_rank() * NTHREADS; i < slices * n;
       i += 2 * NTHREADS)
    if (i / n != mine) part[i] = 0.f;
}

}  // namespace qv
