// The pieces the bf16 tensor-core unit kernels share (msda_mma_kernel,
// swa_mma_kernel, cross_tail_mma_kernel), built on mma.cuh's primitives:
// a product whose weight streams through a ring of cp.async buffers, a
// dense layer's epilogue, the q fragments of a warp's two heads, one
// warp's softmax attention of 16 queries with its scores in registers,
// and a warp-per-row LayerNorm of bf16 rows.
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

}  // namespace qv
