// The kernels the n = 256 units are built from (qavit_v2_extreme_tin: 256
// tokens on a 16 x 16 grid, 16 SWA windows of 16, 128 pooled MSDA rows).
//
// At n = 256 a sample's activations no longer fit one CTA beside the
// weights the n = 64 kernels keep resident (its xn alone is 100 KB at
// C = 192, its MSDA k | v 200 KB), and three of the four units mix every
// token of a sample: MSDA's compressed keys sum all 128 pooled rows, CGA
// attends over all 256 tokens, the CCF-FFN's 3x3 dwconv reaches across
// any row tile.  So the MSDA, CGA and cross/tail units at n = 256 run as a
// fixed sequence of the hand-written kernels below, launched by the
// unit's C entry on the caller's stream, their intermediates as bf16 (at
// the plain version's rounding points) or float32 (cotangents) in one
// scratch buffer the wrapper allocates:
//   gemm_kernel     A @ W on the tensor cores (mma.sync m16n8k16, bf16
//                   operands, float32 sums), 64 x 64 output tiles, the
//                   epilogue a functor (EpiDense: nn.Dense's rounding,
//                   GELU, dropout, a scale, gamma, drop-path, a residual;
//                   EpiF32: a float32 product, stored or added)
//   wgrad_kernel    a weight gradient A^T @ D over a slice of the rows on
//                   the tensor cores, and its bias's column sums, added to
//                   the slice's part of the gradient workspace
//   ln_kernel, ln_bwd_kernel   LayerNorm rows (flax form) and its VJP
//   attn_kernel, attn_bwd_small_kernel (heads of 48), attn_bwd_q_kernel
//   and attn_bwd_k_kernel (CGA's heads of 4)
//                   softmax attention over "virtual heads" on the CUDA
//                   cores: a thread a query (forward, d(q)) or a key or a
//                   (key, column) pair (d(k), d(v)), the sample's keys of
//                   the head in shared memory; the scores in float32 as
//                   common.cuh's attention forms them, the probabilities
//                   through the dropout mask and rounded to bf16 before
//                   PV; the batch-wide NaN guard
//   map_kernel      an element-wise functor (dropout backward, GELU's
//                   derivative, casts)
//   bank256_kernel  the bank-write partials of a branch output: the gate's
//                   softmax over a sample's 256 tokens
// Sums over the batch (weight gradients, bank partials) are kept per
// slice of the rows (P slices, a block a slice and output tile) and summed
// over the slices in a fixed order by the reduction pass (reduce_rows_
// kernel): no float atomics, the results repeat bit for bit.
#pragma once
#include "mma_ops.cuh"

namespace qv {

// rows [lo, hi) of M in slice p of P
__device__ __forceinline__ void split_rows(int M, int P, int p, int& lo,
                                           int& hi) {
  lo = (int)((long long)M * p / P);
  hi = (int)((long long)M * (p + 1) / P);
}

__device__ __forceinline__ float bf(const bf16* p) { return to_f<bf16>(*p); }

// a * b, then + acc, each rounded (no contraction into one FMA), as a
// float32 mul and add of PyTorch's round them; and (x - mu) rstd s + b so
#ifdef QV_EMULATE
__device__ __forceinline__ float mul_rn(float a, float b) { return a * b; }
__device__ __forceinline__ float add_rn(float a, float b) { return a + b; }
#else
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
#endif
__device__ __forceinline__ float ln_out(float v, float mu, float rstd,
                                        float s, float b) {
  return add_rn(mul_rn(mul_rn(v - mu, rstd), s), b);
}

// ---------------------------------------------------------------------------
// A @ W on the tensor cores
// ---------------------------------------------------------------------------

constexpr int GM_B = 64;                  // output tile rows, columns; K step
constexpr int GM_LD = GM_B + 8;           // leading dim of the staged tiles
constexpr int GM_SMEM = 2 * 2 * GM_B * GM_LD;   // bytes: A and W tiles

// out = epi(A @ W): A [M, K] (leading dim lda), W [K, N] (leading dim
// ldw), both bf16 with K, N, lda, ldw multiples of 8 and 16-byte aligned
// rows; e(row, col, v0, v1) takes the float32 sums of columns col, col + 1
template <class E>
struct GemmArgs {
  const bf16* a;
  int lda;
  const bf16* w;
  int ldw;
  int M, N, K;
  E e;
};

// Block: 64 x 64 output tiles in turn; warp w rows 16 (w % 4).. and
// columns 32 (w / 4).., its K in steps of 64 through shared memory (zeros
// past M, N and K).
template <class E>
__global__ void __launch_bounds__(NTHREADS) gemm_kernel(GemmArgs<E> g) {
  QV_SMEM_DECL
  bf16* sa = reinterpret_cast<bf16*>(qv_smem);   // [64 rows][GM_LD]
  bf16* sw = sa + GM_B * GM_LD;                  // [64 k][GM_LD]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3, mt = warp & 3, nh = warp >> 2;
  const int nb = (g.N + GM_B - 1) / GM_B;
  const int tiles = (g.M + GM_B - 1) / GM_B * nb;
  const uint4 zero4{0u, 0u, 0u, 0u};
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile / nb * GM_B, n0 = tile % nb * GM_B;
    float acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    for (int k0 = 0; k0 < g.K; k0 += GM_B) {
      __syncthreads();                 // the last step's reads are done
      for (int i = threadIdx.x; i < GM_B * (GM_B / 8); i += NTHREADS) {
        const int r = i / (GM_B / 8), c = (i - r * (GM_B / 8)) * 8;
        uint4 va = zero4, vw = zero4;
        if (m0 + r < g.M && k0 + c < g.K)
          va = *reinterpret_cast<const uint4*>(g.a + (size_t)(m0 + r) * g.lda +
                                               k0 + c);
        if (k0 + r < g.K && n0 + c < g.N)
          vw = *reinterpret_cast<const uint4*>(g.w + (size_t)(k0 + r) * g.ldw +
                                               n0 + c);
        *reinterpret_cast<uint4*>(sa + r * GM_LD + c) = va;
        *reinterpret_cast<uint4*>(sw + r * GM_LD + c) = vw;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < GM_B; kk += 16) {
        unsigned af[4];
        load_a(af, sa + mt * 16 * GM_LD + kk, GM_LD, lane);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          unsigned wb[4];
          load_b_kn(wb, sw + kk * GM_LD + nh * 32 + np * 16, GM_LD, lane);
          mma_bf16_16816(acc[2 * np], af, wb);
          mma_bf16_16816(acc[2 * np + 1], af, wb + 2);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + nh * 32 + 8 * j + 2 * t;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = m0 + mt * 16 + gq + 8 * hf;
        if (row < g.M && col < g.N)
          g.e(row, col, acc[j][2 * hf], acc[j][2 * hf + 1]);
      }
    }
  }
}

// A mask of a [rows, width] layout (flat index row * width + col) and the
// drop-path factor of the sample of a row (rows of n tokens a sample)
struct RowMasks {
  Drop dr;                // dropout (dr.on 0: none)
  int width;
  int dp_on;              // drop-path on
  unsigned dp_salt, dp_thr;
  float dp_scale;
  int n;                  // rows of a sample
  __device__ __forceinline__ float drop(int row, int col, float v) const {
    if (!dr.on) return v;
    return kept(dr.salt, dr.thr, (unsigned)(row * width + col))
               ? rnd<bf16>(v / dr.keep)
               : 0.f;
  }
  // d(out) -> d(in) of the dropout: the kept ones over keep
  __device__ __forceinline__ float drop_bwd(int row, int col, float g) const {
    if (!dr.on) return g;
    return kept(dr.salt, dr.thr, (unsigned)(row * width + col)) ? g / dr.keep
                                                                 : 0.f;
  }
  __device__ __forceinline__ float path(int row) const {
    if (!dp_on) return 1.f;
    return kept(dp_salt, dp_thr, (unsigned)(row / n)) ? dp_scale : 0.f;
  }
};

__host__ __device__ inline RowMasks row_masks(const Dims& d, int key,
                                              int width) {
  RowMasks m{};
  if (key >= 0) m.dr = Drop{d.train && d.drop_on, d.salt[key], d.thr, d.keep};
  m.width = width;
  m.n = d.n;
  return m;
}

__host__ __device__ inline void with_path(RowMasks& m, const Dims& d,
                                          int key) {
  m.dp_on = d.train;
  m.dp_salt = d.salt[key];
  m.dp_thr = d.dp_thr;
  m.dp_scale = d.dp_scale;
}

// nn.Dense's epilogue and what follows it, as fused_ref rounds: v =
// rnd(rnd(acc) + rnd(bias)) (pre: v saved), GELU (rnd), dropout (rnd(v /
// keep) or 0; post: v saved here), times *mul (rnd), times gamma (rnd),
// times the drop-path factor (rnd), plus the residual res (rnd).  out, pre,
// post and res bf16 [M, ldo] from column ocol.
struct EpiDense {
  bf16* out;
  int ldo, ocol;
  const float* bias;      // indexed by the product's column
  bf16* pre;              // (optional)
  int gelu;
  RowMasks mk;
  const float* mul;       // (optional) [1]
  const float* gamma;     // (optional) [1]
  const bf16* res;        // (optional)
  bf16* post;             // (optional)
  __device__ __forceinline__ float one(int r, int c, float acc) const {
    const size_t at = (size_t)r * ldo + ocol + c;
    float v = dense_out(acc, bias[c]);
    if (pre) pre[at] = from_f<bf16>(v);
    if (gelu) v = rnd<bf16>(gelu_f(v));
    v = mk.drop(r, c, v);
    if (post) post[at] = from_f<bf16>(v);
    if (mul) v = rnd<bf16>(v * mul[0]);
    if (gamma) v = rnd<bf16>(v * gamma[0]);
    if (mk.dp_on) v = rnd<bf16>(v * mk.path(r));
    if (res) v = to_f<bf16>(res[at]) + v;
    return v;
  }
  __device__ __forceinline__ void operator()(int r, int c, float v0,
                                             float v1) const {
    store_bf16x2(out + (size_t)r * ldo + ocol + c,
                 pack_bf16x2(one(r, c, v0), one(r, c + 1, v1)));
  }
};

__host__ __device__ inline EpiDense dense_epi(bf16* out, int ldo,
                                              const float* bias) {
  EpiDense e{};
  e.out = out;
  e.ldo = ldo;
  e.bias = bias;
  return e;
}

// the product rounded to bf16 [M, ldo] from column ocol
struct EpiBf16 {
  bf16* out;
  int ldo, ocol;
  __device__ __forceinline__ void operator()(int r, int c, float v0,
                                             float v1) const {
    store_bf16x2(out + (size_t)r * ldo + ocol + c, pack_bf16x2(v0, v1));
  }
};

// a float32 product [M, ldo] from column ocol, stored or added
struct EpiF32 {
  float* out;
  int ldo, ocol, add;
  __device__ __forceinline__ void operator()(int r, int c, float v0,
                                             float v1) const {
    float* p = out + (size_t)r * ldo + ocol + c;
    if (add) {
      p[0] += v0;
      p[1] += v1;
    } else {
      p[0] = v0;
      p[1] = v1;
    }
  }
};

// ---------------------------------------------------------------------------
// weight gradients: A^T @ D over a slice of the rows
// ---------------------------------------------------------------------------

constexpr int W2_R = 32;                     // rows a step
constexpr int W2_SMEM = 2 * 2 * W2_R * GM_LD;  // bytes: A and D rows

// gws + p wstride + off + k ldg + n += sum over slice p's rows of A[r, k]
// D[r, n] (A [M, K], D [M, N] bf16, leading dims lda, ldd, multiples of 8,
// K and N multiples of 8); with bias_off >= 0 also gws + p wstride +
// bias_off + n += the column sums of D.  A block a (slice, 64 x 64
// output tile).
struct WgradArgs {
  const bf16* a;
  int lda;
  const bf16* d;
  int ldd;
  int M, K, N, P;
  float* gws;
  int wstride, off, ldg, bias_off;
  const int* skip;        // (optional) skip[1] != 0: add nothing
};

// (A product of the attention's path adds nothing where the forward's
// guard tripped: its cotangent is zero there, and A may hold the NaN
// that tripped it.)
template <int = 0>
__global__ void __launch_bounds__(NTHREADS) wgrad_kernel(WgradArgs w) {
  if (w.skip && w.skip[1]) return;
  QV_SMEM_DECL
  bf16* sa = reinterpret_cast<bf16*>(qv_smem);   // [32 rows][GM_LD]
  bf16* sd = sa + W2_R * GM_LD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3, mt = warp & 3, nh = warp >> 2;
  const int kb = (w.K + GM_B - 1) / GM_B, nb = (w.N + GM_B - 1) / GM_B;
  const int jobs = w.P * kb * nb;
  const uint4 zero4{0u, 0u, 0u, 0u};
  for (int job = blockIdx.x; job < jobs; job += gridDim.x) {
    const int p = job / (kb * nb), rest = job - p * kb * nb;
    const int k0 = rest / nb * GM_B, n0 = rest % nb * GM_B;
    int lo, hi;
    split_rows(w.M, w.P, p, lo, hi);
    float acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    float bsum = 0.f;                  // thread c < 64: column n0 + c
    for (int r0 = lo; r0 < hi; r0 += W2_R) {
      __syncthreads();
      for (int i = threadIdx.x; i < W2_R * (GM_B / 8); i += NTHREADS) {
        const int r = i / (GM_B / 8), c = (i - r * (GM_B / 8)) * 8;
        uint4 va = zero4, vd = zero4;
        if (r0 + r < hi && k0 + c < w.K)
          va = *reinterpret_cast<const uint4*>(w.a + (size_t)(r0 + r) * w.lda +
                                               k0 + c);
        if (r0 + r < hi && n0 + c < w.N)
          vd = *reinterpret_cast<const uint4*>(w.d + (size_t)(r0 + r) * w.ldd +
                                               n0 + c);
        *reinterpret_cast<uint4*>(sa + r * GM_LD + c) = va;
        *reinterpret_cast<uint4*>(sd + r * GM_LD + c) = vd;
      }
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < W2_R / 16; ++ks) {
        unsigned af[4];
        load_a_t(af, sa + ks * 16 * GM_LD + mt * 16, GM_LD, lane);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          unsigned db[4];
          load_b_kn(db, sd + ks * 16 * GM_LD + nh * 32 + np * 16, GM_LD,
                    lane);
          mma_bf16_16816(acc[2 * np], af, db);
          mma_bf16_16816(acc[2 * np + 1], af, db + 2);
        }
      }
      if (w.bias_off >= 0 && k0 == 0 && (int)threadIdx.x < GM_B)
        for (int r = 0; r < W2_R; ++r) bsum += bf(sd + r * GM_LD + threadIdx.x);
    }
    float* slice = w.gws + (size_t)p * w.wstride;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + nh * 32 + 8 * j + 2 * t;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int k = k0 + mt * 16 + gq + 8 * hf;
        if (k < w.K && n < w.N) {
          float* q = slice + w.off + (size_t)k * w.ldg + n;
          q[0] += acc[j][2 * hf];
          q[1] += acc[j][2 * hf + 1];
        }
      }
    }
    if (w.bias_off >= 0 && k0 == 0 && (int)threadIdx.x < GM_B &&
        n0 + (int)threadIdx.x < w.N)
      slice[w.bias_off + n0 + threadIdx.x] += bsum;
  }
}

// ---------------------------------------------------------------------------
// LayerNorm rows and their VJP: eight lanes a row (as mma_ops.cuh's
// ln_rows), lane l8 of a row's eight the columns l8 + 8 k, four rows a
// warp at a time
// ---------------------------------------------------------------------------

constexpr int LN_MAXK = 24;       // C / 8 at most (C <= 192)

struct LnArgs {
  const bf16* x;
  int ldx;
  bf16* y;
  int ldy, M, C;
  const float* s;
  const float* b;
};

// the sum over a row's eight lanes
__device__ __forceinline__ float sum8(float v) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// y = rnd(LN(x) s + b) with float32 statistics and the variance E[x^2] -
// mu^2 clamped at 0 (fused_ref.layer_norm)
template <int = 0>
__global__ void __launch_bounds__(NTHREADS) ln_kernel(LnArgs a) {
  const int l8 = threadIdx.x & 7, sub = threadIdx.x >> 3;
  const int kc = a.C / 8;
  for (int r0 = blockIdx.x * (NTHREADS / 8); r0 < a.M;
       r0 += gridDim.x * (NTHREADS / 8)) {
    const int r = r0 + sub;
    const bool live = r < a.M;
    float v[LN_MAXK], s = 0.f, q = 0.f;
#pragma unroll
    for (int k = 0; k < LN_MAXK; ++k)
      if (k < kc && live) {
        v[k] = bf(a.x + (size_t)r * a.ldx + l8 + 8 * k);
        s += v[k];
        q += v[k] * v[k];
      }
    s = sum8(s);
    q = sum8(q);
    const float mu = s / a.C;
    const float rstd = rsqrtf(fmaxf(q / a.C - mu * mu, 0.f) + LN_EPS);
#pragma unroll
    for (int k = 0; k < LN_MAXK; ++k)
      if (k < kc && live) {
        const int c = l8 + 8 * k;
        a.y[(size_t)r * a.ldy + c] =
            from_f<bf16>(ln_out(v[k], mu, rstd, a.s[c], a.b[c]));
      }
  }
}

// d(x) of y = LN(x) s + b given d(y) (float32): dxh = dy s, dx = rstd
// (dxh - mean(dxh) - xh mean(dxh xh)), stored or added (float32 dxf) or
// stored as bf16 (dxb); d(s) = sum dy xh and d(b) = sum dy over slice p's
// rows, added to slice p at off_s, off_b.  A block a slice.
struct LnBwdArgs {
  const bf16* x;
  int ldx;
  const float* dy;
  int lddy;
  float* dxf;
  bf16* dxb;
  int lddx, add, M, C, P;
  const float* s;
  float* gws;
  int wstride, off_s, off_b;
};

template <int = 0>
__global__ void __launch_bounds__(NTHREADS) ln_bwd_kernel(LnBwdArgs a) {
  __shared__ float red[8][2][LN_MAXK * 8];
  const int l8 = threadIdx.x & 7, sub = threadIdx.x >> 3;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kc = a.C / 8;
  for (int p = blockIdx.x; p < a.P; p += gridDim.x) {
    int lo, hi;
    split_rows(a.M, a.P, p, lo, hi);
    float gs[LN_MAXK] = {}, gb[LN_MAXK] = {};
    for (int r0 = lo; r0 < hi; r0 += NTHREADS / 8) {
      const int r = r0 + sub;
      const bool live = r < hi;
      float v[LN_MAXK], g[LN_MAXK], s = 0.f, q = 0.f;
#pragma unroll
      for (int k = 0; k < LN_MAXK; ++k)
        if (k < kc && live) {
          v[k] = bf(a.x + (size_t)r * a.ldx + l8 + 8 * k);
          g[k] = a.dy[(size_t)r * a.lddy + l8 + 8 * k];
          s += v[k];
          q += v[k] * v[k];
        }
      s = sum8(s);
      q = sum8(q);
      const float mu = s / a.C;
      const float rstd = rsqrtf(fmaxf(q / a.C - mu * mu, 0.f) + LN_EPS);
      float m1 = 0.f, m2 = 0.f;
#pragma unroll
      for (int k = 0; k < LN_MAXK; ++k)
        if (k < kc && live) {
          const int c = l8 + 8 * k;
          v[k] = (v[k] - mu) * rstd;          // xh
          gs[k] += g[k] * v[k];
          gb[k] += g[k];
          g[k] *= a.s[c];                     // dxh
          m1 += g[k];
          m2 += g[k] * v[k];
        }
      m1 = sum8(m1) / a.C;
      m2 = sum8(m2) / a.C;
#pragma unroll
      for (int k = 0; k < LN_MAXK; ++k)
        if (k < kc && live) {
          const size_t i = (size_t)r * a.lddx + l8 + 8 * k;
          const float dx = rstd * (g[k] - m1 - v[k] * m2);
          if (a.dxb)
            a.dxb[i] = from_f<bf16>(dx);
          else if (a.add)
            a.dxf[i] += dx;
          else
            a.dxf[i] = dx;
        }
    }
    if (a.gws == nullptr) continue;
    // the warp's four rows' sums, then the block's eight warps', in order
#pragma unroll
    for (int k = 0; k < LN_MAXK; ++k)
#pragma unroll
      for (int o = 8; o < 32; o <<= 1) {
        gs[k] += __shfl_xor_sync(0xffffffffu, gs[k], o);
        gb[k] += __shfl_xor_sync(0xffffffffu, gb[k], o);
      }
    if (lane < 8)
#pragma unroll
      for (int k = 0; k < LN_MAXK; ++k) {
        red[warp][0][l8 + 8 * k] = gs[k];
        red[warp][1][l8 + 8 * k] = gb[k];
      }
    __syncthreads();
    for (int i = threadIdx.x; i < 2 * a.C; i += NTHREADS) {
      const int w = i / a.C, c = i - w * a.C;
      float t = 0.f;
      for (int j = 0; j < 8; ++j) t += red[j][w][c];
      a.gws[(size_t)p * a.wstride + (w ? a.off_b : a.off_s) + c] += t;
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// an element-wise functor over n elements
// ---------------------------------------------------------------------------

// (n < 2^31: 32-bit indices, whose divisions the functors' index
// arithmetic takes at a fraction of a 64-bit division's cost)
template <class F>
struct MapArgs {
  int n;
  F f;
};

template <class F>
__global__ void __launch_bounds__(NTHREADS) map_kernel(MapArgs<F> m) {
  for (int i = blockIdx.x * NTHREADS + threadIdx.x; i < m.n;
       i += gridDim.x * NTHREADS)
    m.f(i);
}

// ---------------------------------------------------------------------------
// softmax attention over virtual heads, on the CUDA cores
// ---------------------------------------------------------------------------
//
// Virtual head vh = (group vh / H, head vh % H) of width D.  Query i of
// sample b: q[(b nq + i) ldq + qcol(vh)]; a sample's own keys j < nko:
// k, v[(b nko + j) ldk + kcol(vh)]; then the shared keys j < nks (the
// bank's rows): ks, vs[j ldks + scol(vh)]; out[(b nq + i) ldo + ocol(vh)],
// each col(vh) = (vh / H) gstride + (vh % H) D.  Dropout of element (b,
// vh, i, j) at flat index ((b VH + vh) nq + i) (nko + nks) + j (the JAX
// layouts [B G, H, n, kv] and [B, H, n, kv]).

constexpr int AT_MAXD = 48;       // head width, at most
constexpr int AT_MAXK = 272;      // keys of a head, at most

struct AttnGeom {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* ks;
  const bf16* vs;
  int ldq, ldk, ldks, ldo;
  int gq, gk, gks, go;         // group strides (columns)
  int B, nq, nko, nks, VH, H, D;
  __device__ __forceinline__ int col(int g, int vh) const {
    return (vh / H) * g + (vh % H) * D;
  }
  __host__ __device__ __forceinline__ int nk() const { return nko + nks; }
  __device__ __forceinline__ const bf16* key(int b, int vh, int j) const {
    return j < nko ? k + (size_t)(b * nko + j) * ldk + col(gk, vh)
                   : ks + (size_t)(j - nko) * ldks + col(gks, vh);
  }
  __device__ __forceinline__ const bf16* val(int b, int vh, int j) const {
    return j < nko ? v + (size_t)(b * nko + j) * ldk + col(gk, vh)
                   : vs + (size_t)(j - nko) * ldks + col(gks, vh);
  }
  __device__ __forceinline__ unsigned mask_base(int b, int vh) const {
    return (unsigned)((b * VH + vh) * nq) * (unsigned)nk();
  }
};

struct AttnArgs {
  AttnGeom g;
  bf16* out;
  Drop dr;
  int guard;
  int* bad;               // set to 1 when q, k, v or out holds a NaN
};

// the head's keys and values of sample b into shared memory as float32
// ([AT_MAXK][D] each); true if one is NaN
__device__ __forceinline__ bool stage_keys(const AttnGeom& g, int b, int vh,
                                           float* sk, float* sv) {
  bool nan_seen = false;
  for (int i = threadIdx.x; i < g.nk() * g.D; i += NTHREADS) {
    const int j = i / g.D, c = i - j * g.D;
    sk[i] = bf(g.key(b, vh, j) + c);
    sv[i] = bf(g.val(b, vh, j) + c);
    nan_seen = nan_seen || isnan(sk[i]) || isnan(sv[i]);
  }
  return nan_seen;
}

__device__ __forceinline__ float dot_d(const float* q, const float* k,
                                       int D) {
  float s = 0.f;
  for (int c = 0; c < D; ++c) s = fmaf(q[c], k[c], s);
  return s;
}

// A block a (sample, virtual head), a thread a query: its scores'
// maximum, their exponentials' sum, then rnd(P) (through the dropout) V
// rounded to bf16.  The divisions by sqrt(D), by the row's sum and by keep
// are products with reciprocals (exact for D = 4; within an ulp of the
// quotient otherwise, before P's rounding to bf16): an IEEE division a
// score costs more than the score.
template <int D>
__global__ void __launch_bounds__(NTHREADS) attn_kernel(AttnArgs a) {
  QV_SMEM_DECL
  __shared__ int nan_blk;
  float* sk = qv_smem;
  float* sv = sk + AT_MAXK * D;
  const AttnGeom& g = a.g;
  const float isd = 1.f / sqrtf((float)D), inv_keep = 1.f / a.dr.keep;
  const int nk = g.nk();
  if (threadIdx.x == 0) nan_blk = 0;
  bool nan_seen = false;
  for (int job = blockIdx.x; job < g.B * g.VH; job += gridDim.x) {
    const int b = job / g.VH, vh = job - b * g.VH;
    __syncthreads();
    nan_seen |= stage_keys(g, b, vh, sk, sv);
    __syncthreads();
    const unsigned base = g.mask_base(b, vh);
    for (int i = threadIdx.x; i < g.nq; i += NTHREADS) {
      float q[D], o[D];
      const bf16* qp = g.q + (size_t)(b * g.nq + i) * g.ldq + g.col(g.gq, vh);
#pragma unroll
      for (int c = 0; c < D; ++c) {
        q[c] = bf(qp + c);
        o[c] = 0.f;
        nan_seen = nan_seen || isnan(q[c]);
      }
      float mx = -INFINITY;
      for (int j = 0; j < nk; ++j)
        mx = fmaxf(mx, dot_d(q, sk + j * D, D) * isd);
      float sum = 0.f;
      for (int j = 0; j < nk; ++j)
        sum += expf(dot_d(q, sk + j * D, D) * isd - mx);
      const float inv = 1.f / sum;
      for (int j = 0; j < nk; ++j) {
        float p = expf(dot_d(q, sk + j * D, D) * isd - mx) * inv;
        if (a.dr.on)
          p = kept(a.dr.salt, a.dr.thr, base + (unsigned)(i * nk + j))
                  ? p * inv_keep
                  : 0.f;
        p = rnd<bf16>(p);
#pragma unroll
        for (int c = 0; c < D; ++c) o[c] = fmaf(p, sv[j * D + c], o[c]);
      }
      bf16* op = a.out + (size_t)(b * g.nq + i) * g.ldo + g.col(g.go, vh);
#pragma unroll
      for (int c = 0; c < D; ++c) {
        op[c] = from_f<bf16>(o[c]);
        nan_seen = nan_seen || isnan(o[c]);
      }
    }
  }
  if (a.guard && nan_seen) nan_blk = 1;
  __syncthreads();
  if (threadIdx.x == 0 && nan_blk) atomicOr(a.bad, 1);
}

// The attention's VJP given the cotangent dO of its output (float32, at
// out's columns, leading dim ldo); for heads over many keys (CGA's 272):
// d(q) by attn_bwd_q_kernel, a thread a query, which also leaves each query row's (max, 1 / sum, sum_j P dP) in
// stats [B VH nq][3]; d(k), d(v) by attn_bwd_k_kernel, a thread a key,
// the sample's queries, dO rows and stats in shared memory.  dP of a
// dropped probability is 0, of a kept one dPd / keep; dS = P (dP - sum P
// dP); d(q) = dS K / sqrt(D), d(k) = dS^T Q / sqrt(D), d(v) = rnd(P')^T
// dO with P' the probabilities PV used.  d(q) goes to dq (float32, q's
// layout, leading dim lddq), the own keys' to dk, dv (float32, k's
// layout, leading dim lddk), the shared keys' to dks, dvs [B VH][nks][D]
// per (sample, virtual head).  Where the forward's guard tripped
// (flag[1]) all are zero.
struct AttnBwdArgs {
  AttnGeom g;
  const float* dout;
  float* dq;
  float* dk;
  float* dv;
  float* dks;
  float* dvs;
  float* stats;
  int lddq, lddk;
  Drop dr;
  const int* flag;
};

template <int D>
__global__ void __launch_bounds__(NTHREADS) attn_bwd_q_kernel(AttnBwdArgs a) {
  QV_SMEM_DECL
  float* sk = qv_smem;
  float* sv = sk + AT_MAXK * D;
  const AttnGeom& g = a.g;
  const float isd = 1.f / sqrtf((float)D), inv_keep = 1.f / a.dr.keep;
  const int nk = g.nk();
  const bool zero = a.flag[1] != 0;
  for (int job = blockIdx.x; job < g.B * g.VH; job += gridDim.x) {
    const int b = job / g.VH, vh = job - b * g.VH;
    __syncthreads();
    stage_keys(g, b, vh, sk, sv);
    __syncthreads();
    const unsigned base = g.mask_base(b, vh);
    for (int i = threadIdx.x; i < g.nq; i += NTHREADS) {
      float q[D], go[D], dq[D];
      const size_t row = (size_t)(b * g.nq + i);
      const bf16* qp = g.q + row * g.ldq + g.col(g.gq, vh);
      const float* gp = a.dout + row * g.ldo + g.col(g.go, vh);
#pragma unroll
      for (int c = 0; c < D; ++c) {
        q[c] = bf(qp + c);
        go[c] = gp[c];
        dq[c] = 0.f;
      }
      float* dqp = a.dq + row * a.lddq + g.col(g.gq, vh);
      if (zero) {
#pragma unroll
        for (int c = 0; c < D; ++c) dqp[c] = 0.f;
        continue;
      }
      float mx = -INFINITY;
      for (int j = 0; j < nk; ++j)
        mx = fmaxf(mx, dot_d(q, sk + j * D, D) * isd);
      float sum = 0.f;
      for (int j = 0; j < nk; ++j)
        sum += expf(dot_d(q, sk + j * D, D) * isd - mx);
      const float inv = 1.f / sum;
      auto dp_of = [&](int j) {
        const float dpd = dot_d(go, sv + j * D, D);
        if (!a.dr.on) return dpd;
        return kept(a.dr.salt, a.dr.thr, base + (unsigned)(i * nk + j))
                   ? dpd * inv_keep
                   : 0.f;
      };
      float dsum = 0.f;
      for (int j = 0; j < nk; ++j) {
        const float p = expf(dot_d(q, sk + j * D, D) * isd - mx) * inv;
        dsum = fmaf(p, dp_of(j), dsum);
      }
      for (int j = 0; j < nk; ++j) {
        const float p = expf(dot_d(q, sk + j * D, D) * isd - mx) * inv;
        const float ds = p * (dp_of(j) - dsum);
#pragma unroll
        for (int c = 0; c < D; ++c) dq[c] = fmaf(ds, sk[j * D + c], dq[c]);
      }
#pragma unroll
      for (int c = 0; c < D; ++c) dqp[c] = dq[c] * isd;
      float* st = a.stats + ((size_t)(b * g.VH + vh) * g.nq + i) * 3;
      st[0] = mx;
      st[1] = inv;
      st[2] = dsum;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS) attn_bwd_k_kernel(AttnBwdArgs a) {
  QV_SMEM_DECL
  float* sq = qv_smem;                     // [nq][D]
  float* sg = sq + 256 * D;                // [nq][D] dO
  float* st = sg + 256 * D;                // [nq][3]
  const AttnGeom& g = a.g;
  const float isd = 1.f / sqrtf((float)D), inv_keep = 1.f / a.dr.keep;
  const int nk = g.nk();
  const bool zero = a.flag[1] != 0;
  for (int job = blockIdx.x; job < g.B * g.VH; job += gridDim.x) {
    const int b = job / g.VH, vh = job - b * g.VH;
    __syncthreads();
    if (!zero) {
      for (int e = threadIdx.x; e < g.nq * D; e += NTHREADS) {
        const int i = e / D, c = e - i * D;
        const size_t row = (size_t)(b * g.nq + i);
        sq[e] = bf(g.q + row * g.ldq + g.col(g.gq, vh) + c);
        sg[e] = a.dout[row * g.ldo + g.col(g.go, vh) + c];
      }
      for (int e = threadIdx.x; e < g.nq * 3; e += NTHREADS)
        st[e] = a.stats[(size_t)(b * g.VH + vh) * g.nq * 3 + e];
    }
    __syncthreads();
    const unsigned base = g.mask_base(b, vh);
    for (int j = threadIdx.x; j < nk; j += NTHREADS) {
      float kr[D], vr[D], dk[D], dv[D];
      const bf16* kp = g.key(b, vh, j);
      const bf16* vp = g.val(b, vh, j);
#pragma unroll
      for (int c = 0; c < D; ++c) {
        kr[c] = bf(kp + c);
        vr[c] = bf(vp + c);
        dk[c] = dv[c] = 0.f;
      }
      if (!zero)
        for (int i = 0; i < g.nq; ++i) {
          const float* qi = sq + i * D;
          const float* gi = sg + i * D;
          const float p =
              expf(dot_d(qi, kr, D) * isd - st[3 * i]) * st[3 * i + 1];
          const float dpd = dot_d(gi, vr, D);
          float pu = p, dp = dpd;
          if (a.dr.on) {
            const bool kk =
                kept(a.dr.salt, a.dr.thr, base + (unsigned)(i * nk + j));
            pu = kk ? p * inv_keep : 0.f;
            dp = kk ? dpd * inv_keep : 0.f;
          }
          pu = rnd<bf16>(pu);
          const float ds = p * (dp - st[3 * i + 2]);
#pragma unroll
          for (int c = 0; c < D; ++c) {
            dk[c] = fmaf(ds, qi[c], dk[c]);
            dv[c] = fmaf(pu, gi[c], dv[c]);
          }
        }
      float* dkp;
      float* dvp;
      if (j < g.nko) {
        const size_t off = (size_t)(b * g.nko + j) * a.lddk + g.col(g.gk, vh);
        dkp = a.dk + off;
        dvp = a.dv + off;
      } else {
        const size_t off =
            ((size_t)(b * g.VH + vh) * g.nks + (j - g.nko)) * D;
        dkp = a.dks + off;
        dvp = a.dvs + off;
      }
#pragma unroll
      for (int c = 0; c < D; ++c) {
        dkp[c] = dk[c] * isd;
        dvp[c] = dv[c];
      }
    }
  }
}

// The same VJP where a head has few keys (nk <= AT_SMALL: MSDA's 32 + 16,
// the cross branch's 16), in one kernel: a thread a query forms its row's
// P, dS and the probabilities PV used into shared memory ([nq][AT_SMALL]
// each) and its d(q); then the block's threads take the (key, column)
// pairs of d(k) = dS^T Q / sqrt(D) and d(v) = P'^T dO, the queries' rows
// read from device memory (each element read by the threads of its
// column, in L1).  A thread a key, as attn_bwd_k_kernel, kept a few warps
// busy an SM at 48 keys.
constexpr int AT_SMALL = 48;

template <int D>
__global__ void __launch_bounds__(NTHREADS) attn_bwd_small_kernel(
    AttnBwdArgs a) {
  QV_SMEM_DECL
  float* sk = qv_smem;                     // [AT_SMALL][D]
  float* sv = sk + AT_SMALL * D;
  float* sds = sv + AT_SMALL * D;          // [nq][AT_SMALL]: dS
  float* spu = sds + 256 * AT_SMALL;       // [nq][AT_SMALL]: rnd(P')
  const AttnGeom& g = a.g;
  const float isd = 1.f / sqrtf((float)D), inv_keep = 1.f / a.dr.keep;
  const int nk = g.nk();
  const bool zero = a.flag[1] != 0;
  for (int job = blockIdx.x; job < g.B * g.VH; job += gridDim.x) {
    const int b = job / g.VH, vh = job - b * g.VH;
    __syncthreads();
    stage_keys(g, b, vh, sk, sv);
    __syncthreads();
    const unsigned base = g.mask_base(b, vh);
    for (int i = threadIdx.x; i < g.nq; i += NTHREADS) {
      float q[D], go[D], dq[D];
      const size_t row = (size_t)(b * g.nq + i);
      const bf16* qp = g.q + row * g.ldq + g.col(g.gq, vh);
      const float* gp = a.dout + row * g.ldo + g.col(g.go, vh);
#pragma unroll
      for (int c = 0; c < D; ++c) {
        q[c] = bf(qp + c);
        go[c] = gp[c];
        dq[c] = 0.f;
      }
      float* ds_i = sds + i * AT_SMALL;
      float* pu_i = spu + i * AT_SMALL;
      float* dqp = a.dq + row * a.lddq + g.col(g.gq, vh);
      if (zero) {
        for (int j = 0; j < nk; ++j) ds_i[j] = pu_i[j] = 0.f;
#pragma unroll
        for (int c = 0; c < D; ++c) dqp[c] = 0.f;
        continue;
      }
      float mx = -INFINITY;
      for (int j = 0; j < nk; ++j) {
        ds_i[j] = dot_d(q, sk + j * D, D) * isd;    // the scores, first
        mx = fmaxf(mx, ds_i[j]);
      }
      float sum = 0.f;
      for (int j = 0; j < nk; ++j) {
        ds_i[j] = expf(ds_i[j] - mx);
        sum += ds_i[j];
      }
      const float inv = 1.f / sum;
      float dsum = 0.f;
      for (int j = 0; j < nk; ++j) {
        const float p = ds_i[j] * inv;
        const float dpd = dot_d(go, sv + j * D, D);
        float pu = p, dp = dpd;
        if (a.dr.on) {
          const bool kk =
              kept(a.dr.salt, a.dr.thr, base + (unsigned)(i * nk + j));
          pu = kk ? p * inv_keep : 0.f;
          dp = kk ? dpd * inv_keep : 0.f;
        }
        pu_i[j] = rnd<bf16>(pu);
        ds_i[j] = p;
        dsum = fmaf(p, dp, dsum);
      }
      // dS needs the row's sum of P dP first: dP is formed again
      for (int j = 0; j < nk; ++j) {
        const float p = ds_i[j];
        float dp = dot_d(go, sv + j * D, D);
        if (a.dr.on)
          dp = kept(a.dr.salt, a.dr.thr, base + (unsigned)(i * nk + j))
                   ? dp * inv_keep
                   : 0.f;
        const float ds = p * (dp - dsum);
        ds_i[j] = ds;
#pragma unroll
        for (int c = 0; c < D; ++c) dq[c] = fmaf(ds, sk[j * D + c], dq[c]);
      }
#pragma unroll
      for (int c = 0; c < D; ++c) dqp[c] = dq[c] * isd;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < nk * D; e += NTHREADS) {
      const int j = e / D, c = e - j * D;
      float dk = 0.f, dv = 0.f;
      if (!zero)
        for (int i = 0; i < g.nq; ++i) {
          const size_t row = (size_t)(b * g.nq + i);
          dk = fmaf(sds[i * AT_SMALL + j],
                    bf(g.q + row * g.ldq + g.col(g.gq, vh) + c), dk);
          dv = fmaf(spu[i * AT_SMALL + j],
                    a.dout[row * g.ldo + g.col(g.go, vh) + c], dv);
        }
      if (j < g.nko) {
        const size_t off = (size_t)(b * g.nko + j) * a.lddk + g.col(g.gk, vh);
        a.dk[off + c] = dk * isd;
        a.dv[off + c] = dv;
      } else {
        const size_t off =
            ((size_t)(b * g.VH + vh) * g.nks + (j - g.nko)) * D;
        a.dks[off + c] = dk * isd;
        a.dvs[off + c] = dv;
      }
    }
  }
}

// the shared keys' gradients of attn_bwd_k_kernel ([B VH][nks][D]) summed
// over slice p's samples and the groups into out [P][nks][H D] (added to
// slice p's part of the gradient workspace where out is its field: out +
// p stride)
struct SharedSumArgs {
  const float* in;
  float* out;
  size_t stride;          // between the slices of out
  int B, VH, H, D, nks, P;
};

template <int = 0>
__global__ void __launch_bounds__(NTHREADS) shared_sum_kernel(SharedSumArgs a) {
  const int w = a.H * a.D, n = a.nks * w;
  for (int job = blockIdx.x; job < a.P; job += gridDim.x) {
    int lo, hi;
    split_rows(a.B, a.P, job, lo, hi);
    for (int e = threadIdx.x; e < n; e += NTHREADS) {
      const int j = e / w, hc = e - j * w, h = hc / a.D, c = hc - h * a.D;
      float s = 0.f;
      for (int b = lo; b < hi; ++b)
        for (int vh = h; vh < a.VH; vh += a.H)
          s += a.in[((size_t)(b * a.VH + vh) * a.nks + j) * a.D + c];
      a.out[job * a.stride + e] += s;
    }
  }
}

// ---------------------------------------------------------------------------
// the bank's projections (cross and CGA): dense of the rounded bank rows,
// and its VJP per slice
// ---------------------------------------------------------------------------

// slice p of the projected rows' cotangent dkp [P][S][N] (float32) ->
// d(W) [C, N], d(b) [N] and d(bank rows) [S, C] added to slice p at off_w,
// off_b, off_x: d(W) = rnd(rows)^T dkp, d(rows) = dkp rnd(W)^T
struct BankProjBwdArgs {
  const float* rows;      // [S, C] bank rows (rounded here)
  const float* w;         // [C, N]
  const float* dkp;       // [P][S][N]
  float* gws;
  int wstride, off_w, off_b, off_x, S, C, N, P;
};

template <int = 0>
__global__ void __launch_bounds__(NTHREADS) bank_proj_bwd_kernel(BankProjBwdArgs a) {
  for (int p = blockIdx.x; p < a.P; p += gridDim.x) {
    const float* g = a.dkp + (size_t)p * a.S * a.N;
    float* sl = a.gws + (size_t)p * a.wstride;
    for (int e = threadIdx.x; e < a.C * a.N; e += NTHREADS) {
      const int k = e / a.N, n = e - k * a.N;
      float s = 0.f;
      for (int j = 0; j < a.S; ++j)
        s = fmaf(rnd<bf16>(a.rows[j * a.C + k]), g[j * a.N + n], s);
      sl[a.off_w + e] += s;
    }
    for (int n = threadIdx.x; n < a.N; n += NTHREADS) {
      float s = 0.f;
      for (int j = 0; j < a.S; ++j) s += g[j * a.N + n];
      sl[a.off_b + n] += s;
    }
    for (int e = threadIdx.x; e < a.S * a.C; e += NTHREADS) {
      const int j = e / a.C, k = e - j * a.C;
      float s = 0.f;
      for (int n = 0; n < a.N; ++n)
        s = fmaf(g[j * a.N + n], rnd<bf16>(a.w[k * a.N + n]), s);
      sl[a.off_x + e] += s;
    }
  }
}

// ---------------------------------------------------------------------------
// the bank-write partials of a branch output at n = 256
// ---------------------------------------------------------------------------
//
// fused_ref.bank_write_partial over out [B, 256, C] (bf16): per sample,
// t = LN(rnd(LN(out; the branch's norm)); write_norm) with jnp.var's
// two-pass variance, the gate's logits t @ Wg + bg for all 256 tokens (64
// rows at a time, as bank_tile_partials forms them), the gate's softmax
// over the 256 (a warp a bank row), then part_v[m] += sum_n gate[n, m]
// t[n] (t formed again, 64 rows at a time) and the gates' sums, per
// thread over the slice's samples; the slice stores part_v and the gate
// sums (bank_store_sums) for the reduction and the compression pass
// (qv_bank_compress) after it.  A block a slice of the samples.
constexpr int BK_N = 256;
constexpr int BK_SMEM =
    4 * (BP_ROWS * BP_LDT + BK_N * BP_S + BP_C * BP_S + BP_S);

struct Bank256Args {
  const bf16* out;
  BankWrite bw;
  int B, S, P;
};

// t of the 64 rows of out from row r0 (leading dim BP_C) into t
__device__ __forceinline__ void bank_t_rows(const bf16* out,
                                            const BankWrite& bw, float* t) {
  constexpr int P = BP_C / 16;
  const int sub = threadIdx.x >> 3, c0 = 2 * (threadIdx.x & 7);
#pragma unroll 1
  for (int i = 0; i < BP_ROWS / (NTHREADS / 8); ++i) {
    const int r = sub + i * (NTHREADS / 8);
    float v[2 * P], s = 0.f, sq = 0.f;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const unsigned u =
          *reinterpret_cast<const unsigned*>(out + r * BP_C + c0 + 16 * k);
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
}

template <int = 0>
__global__ void __launch_bounds__(NTHREADS) bank256_kernel(Bank256Args a) {
  QV_SMEM_DECL
  float* t = qv_smem;                        // [64][BP_LDT]
  float* gate = t + BP_ROWS * BP_LDT;        // [256][BP_S]
  float* wg = gate + BK_N * BP_S;            // [C][BP_S], zero past S
  float* scratch = wg + BP_C * BP_S;         // [BP_S]
  const BankWrite& bw = a.bw;
  const int S = a.S;
  for (int i = threadIdx.x; i < BP_C * BP_S; i += NTHREADS) {
    const int k = i / BP_S, m = i - k * BP_S;
    wg[i] = m < S ? bw.gate_w[k * S + m] : 0.f;
  }
  BankSums sums;
  bank_sums_zero(sums);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int p = blockIdx.x; p < a.P; p += gridDim.x) {
    int lo, hi;
    split_rows(a.B, a.P, p, lo, hi);
    for (int b = lo; b < hi; ++b) {
      const bf16* ob = a.out + (size_t)b * BK_N * BP_C;
      for (int tl = 0; tl < BK_N / BP_ROWS; ++tl) {   // the gate's logits
        __syncthreads();
        bank_t_rows(ob + tl * BP_ROWS * BP_C, bw, t);
        __syncthreads();
        const int r = threadIdx.x >> 2, m0 = 4 * (threadIdx.x & 3);
        float ac[4] = {0.f, 0.f, 0.f, 0.f};
        for (int k = 0; k < BP_C; ++k) {
          const float tv = t[r * BP_LDT + k];
#pragma unroll
          for (int j = 0; j < 4; ++j) ac[j] = fmaf(tv, wg[k * BP_S + m0 + j], ac[j]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
          gate[(tl * BP_ROWS + r) * BP_S + m0 + j] =
              m0 + j < S ? ac[j] + bw.gate_b[m0 + j] : 0.f;
      }
      __syncthreads();
      for (int m = warp; m < S; m += NTHREADS / 32) {   // softmax over 256
        float e[BK_N / 32], mx = -INFINITY;
#pragma unroll
        for (int k = 0; k < BK_N / 32; ++k) {
          e[k] = gate[(lane + 32 * k) * BP_S + m];
          mx = fmaxf(mx, e[k]);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        float sum = 0.f;
#pragma unroll
        for (int k = 0; k < BK_N / 32; ++k) {
          e[k] = expf(e[k] - mx);
          sum += e[k];
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
#pragma unroll
        for (int k = 0; k < BK_N / 32; ++k)
          gate[(lane + 32 * k) * BP_S + m] = e[k] / sum;
      }
      for (int tl = 0; tl < BK_N / BP_ROWS; ++tl) {   // part_v, gate sums
        __syncthreads();
        bank_t_rows(ob + tl * BP_ROWS * BP_C, bw, t);
        __syncthreads();
        const float* gt = gate + tl * BP_ROWS * BP_S;
        if ((int)threadIdx.x < BP_C)
          for (int r = 0; r < BP_ROWS; ++r) {
            const float tv = t[r * BP_LDT + threadIdx.x];
#pragma unroll
            for (int m = 0; m < BP_S; ++m)
              sums.v[m] = fmaf(gt[r * BP_S + m], tv, sums.v[m]);
          }
        if ((int)threadIdx.x < S)
          for (int r = 0; r < BP_ROWS; ++r)
            sums.gate += gt[r * BP_S + threadIdx.x];
      }
    }
    __syncthreads();
    bank_store_sums(sums, S, scratch,
                    a.bw.part + (size_t)p * 2 * S * BP_C);
    bank_sums_zero(sums);
  }
}

}  // namespace qv

// --- host side: launches and the scratch carve-up -------------------------

// the most blocks a launch below takes (each kernel walks its work in
// strides of the grid): on the host, where an emulated block is 256
// threads started anew, a few
#ifdef QV_EMULATE
constexpr int QV_GRID_CAP = 2;
#else
constexpr int QV_GRID_CAP = 4096;
#endif
static int qv_grid(long long jobs) {
  return (int)(jobs < 1 ? 1 : jobs < QV_GRID_CAP ? jobs : QV_GRID_CAP);
}

// `n` bytes of the scratch buffer, 256-byte aligned; with base null only
// counted (the entry's _scratch function sizes the buffer this way)
struct QvBump {
  char* base;
  size_t used = 0;
  template <typename T>
  T* take(size_t n) {
    used = (used + 255) / 256 * 256;
    T* p = base ? reinterpret_cast<T*>(base + used) : nullptr;
    used += n * sizeof(T);
    return p;
  }
};

template <class E>
static int qv_gemm(const qv::bf16* a, int lda, const qv::bf16* w, int ldw,
                   int M, int N, int K, const E& e, void* stream) {
  const qv::GemmArgs<E> g{a, lda, w, ldw, M, N, K, e};
  const int tiles = (M + qv::GM_B - 1) / qv::GM_B * ((N + qv::GM_B - 1) / qv::GM_B);
  return qv_launch(qv::gemm_kernel<E>, g, qv::GM_SMEM, stream,
                   qv_grid(tiles));
}

static int qv_wgrad(const qv::bf16* a, int lda, const qv::bf16* d, int ldd,
                    int M, int K, int N, int P, float* gws, int wstride,
                    float* field, int ldg, float* bias, void* stream,
                    const int* skip = nullptr) {
  const qv::WgradArgs w{a, lda, d, ldd, M, K, N, P, gws, wstride,
                        (int)(field - gws), ldg,
                        bias ? (int)(bias - gws) : -1, skip};
  const int jobs = P * ((K + qv::GM_B - 1) / qv::GM_B) *
                   ((N + qv::GM_B - 1) / qv::GM_B);
  return qv_launch(qv::wgrad_kernel<>, w, qv::W2_SMEM, stream, qv_grid(jobs));
}

static int qv_ln(const qv::bf16* x, int ldx, qv::bf16* y, int ldy, int M,
                 int C, const float* s, const float* b, void* stream) {
  const qv::LnArgs a{x, ldx, y, ldy, M, C, s, b};
  return qv_launch(qv::ln_kernel<>, a, 0, stream, qv_grid((M + 7) / 8));
}

template <class F>
static int qv_map(long long n, const F& f, void* stream) {
  if (n >= (1LL << 31)) return qv::ERR_ARGS;
  const qv::MapArgs<F> m{(int)n, f};
  const long long blocks = (n + qv::NTHREADS - 1) / qv::NTHREADS;
  return qv_launch(qv::map_kernel<F>, m, 0, stream, qv_grid(blocks));
}

template <int D>
static int qv_attn(const qv::AttnArgs& a, void* stream) {
  const int jobs = a.g.B * a.g.VH;
  return qv_launch(qv::attn_kernel<D>, a, 2 * qv::AT_MAXK * D * 4, stream,
                   qv_grid(jobs));
}

// The attention's VJP: heads of 48 (MSDA, cross; at most AT_SMALL keys)
// in one kernel, CGA's heads of 4 over 272 keys in two.
template <int D>
static int qv_attn_bwd(const qv::AttnBwdArgs& a, void* stream) {
  const int jobs = a.g.B * a.g.VH;
  const int grid = qv_grid(jobs);
  if constexpr (D > 4) {
    if (a.g.nk() > qv::AT_SMALL || a.g.nq > 256) return qv::ERR_ARGS;
    return qv_launch(qv::attn_bwd_small_kernel<D>, a,
                     (2 * qv::AT_SMALL * D + 2 * 256 * qv::AT_SMALL) * 4,
                     stream, grid);
  } else {
    const int rc = qv_launch(qv::attn_bwd_q_kernel<D>, a,
                             2 * qv::AT_MAXK * D * 4, stream, grid);
    if (rc) return rc;
    return qv_launch(qv::attn_bwd_k_kernel<D>, a,
                     (2 * 256 * D + 3 * 256) * 4, stream, grid);
  }
}

// return a launch's error code, if any
#define QV_TRY(x)              \
  do {                         \
    const int rc_ = (x);       \
    if (rc_ != 0) return rc_;  \
  } while (0)

// the dropout of mask `key` (off outside training or at rate 0), on the host
inline qv::Drop qv_drop(const qv::Dims& d, int key) {
  return qv::Drop{d.train && d.drop_on, d.salt[key], d.thr, d.keep};
}

// The n = 256 geometry every n = 256 entry takes (fused_kernels.
// kernel_geometry_error at n = 256, and the widths of the *_mma_error
// functions): C = 192, 4 heads of 48, linformer_k 32, 6 CGA groups of
// cperg 16, hidden widths 96, d_c 48, at most 16 bank rows, 16 x 16 grid.
inline bool qv_n256(const qv::Dims& d) {
  return d.n == 256 && d.side == 16 && d.nw == 16 && d.c == 192 &&
         d.heads == 4 && d.lin_k == 32 && d.bank_s <= 16 && d.bank_s > 0 &&
         d.msda_keep <= 128 && d.groups == 6 && d.cperg == 16 &&
         d.ccf_hidden == 96 && d.bottleneck_hidden == 96 && d.d_c == 48 &&
         d.grid > 0;
}

// the bank-write partials of a branch output `out` [B, 256, C]: d.grid
// slices into bw.part, their sum into bw.part_out, part_k formed there
static int qv_bank256(const qv::bf16* out, const qv::BankWrite& bw,
                      const qv::Dims& d, void* stream) {
  const qv::Bank256Args b{out, bw, d.B, d.bank_s, d.grid};
  QV_TRY(qv_launch(qv::bank256_kernel<>, b, qv::BK_SMEM, stream,
                   qv_grid(d.grid)));
  QV_TRY(qv_reduce(bw.part, bw.part_out, d.grid, 2 * d.bank_s * d.c,
                   d.rgrid, stream));
  return qv_bank_compress(bw.part_out, bw.comp_w, bw.comp_b, d.bank_s,
                          stream);
}

// dst[i] = rnd(src[i]) (float32 -> bf16)
struct QvToBf16 {
  const float* src;
  qv::bf16* dst;
  __device__ void operator()(int i) const {
    dst[i] = qv::from_f<qv::bf16>(src[i]);
  }
};

struct QvZero {
  float* dst;
  __device__ void operator()(int i) const { dst[i] = 0.f; }
};

// dst[i] = 0 where the guard flag (flag[1]) is set: the attention output
// the batch-wide NaN guard zeroes
struct QvZeroIf {
  qv::bf16* dst;
  const int* flag;
  __device__ void operator()(int i) const {
    if (flag[1]) dst[i] = qv::from_f<qv::bf16>(0.f);
  }
};

// rnd(drop_bwd(g)) of a [M, width] dropout mask on bf16 cotangents
struct QvDropBwd {
  const qv::bf16* g;
  qv::bf16* dst;
  qv::RowMasks mk;
  __device__ void operator()(int i) const {
    const int r = (int)(i / mk.width), c = (int)(i % mk.width);
    dst[i] = qv::from_f<qv::bf16>(mk.drop_bwd(r, c, qv::bf(g + i)));
  }
};

static int qv_ln_bwd(const qv::bf16* x, int ldx, const float* dy, int lddy,
                     float* dxf, qv::bf16* dxb, int lddx, int add, int M,
                     int C, int P, const float* s, float* gws, int wstride,
                     float* gs, float* gb, void* stream) {
  const qv::LnBwdArgs a{x, ldx, dy, lddy, dxf, dxb, lddx, add, M, C, P, s,
                        gws, wstride, (int)(gs - gws), (int)(gb - gws)};
  return qv_launch(qv::ln_bwd_kernel<>, a, 0, stream, qv_grid(P));
}
