// Shared pieces of the fused-block unit kernels: forward (eval and
// train) and backward.
//
// Every unit kernel holds one sample (SWA: one window of a sample) at a
// time in a thread block: its tokens, its intermediates and its attention
// scores stay in shared memory as float32; weights are float32 in device
// memory and stay in L2 across the grid.  The token geometry is a runtime
// value (Dims): n = 16 tokens in one SWA window (hqavit_c100), or, in
// eval, n = 64 on an 8x8 grid in four 16-token windows (hqavit_tiny_in),
// where the MSDA, CGA and cross/tail kernels loop over row tiles of NT
// tokens.  The CUDA-core backward kernels take n = 16 only (the bf16
// tensor-core ones, on mma_ops.cuh, also n = 64).  A block loops over the
// samples b = blockIdx.x, blockIdx.x + gridDim.x, ... (d.grid blocks in
// all), so
// sums across samples (the bank-write partials, the weight gradients) are
// kept per block in its own slice of a float32 workspace and summed over
// the blocks in a fixed order by reduce_rows_kernel: no float atomics,
// and the result repeats bit for bit.  Values are rounded to the working
// type (float or bf16) at the points where the plain PyTorch version
// (qavit_tpu_torch/kernels/fused_ref.py) rounds, and every product is
// accumulated in float32.
//
// The C entry points take one argument struct by pointer, launch on the
// caller's stream and return cudaGetLastError().  The structs are
// mirrored field for field by ctypes in kernels/fused_kernels.py;
// qv_struct_size() lets the loader check the two layouts agree.
#pragma once

#ifdef QV_EMULATE
#include "qv_emulate.h"   // host emulation of the CUDA built-ins, for tests
#else
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#define QV_SMEM_DECL extern __shared__ __align__(16) float qv_smem[];
#endif

namespace qv {

constexpr int NT = 16;          // row-tile width: the tokens of one SWA
                                // window, and of one tile of a sample
constexpr int WS = 4;           // SWA window side (NT = WS * WS)
constexpr int NTHREADS = 256;   // threads per block
// The unit kernels declare __launch_bounds__(NTHREADS, 1): their shared
// memory allows one block per SM (the CGA forward's two: (NTHREADS, 2)),
// and saying so lets ptxas spend registers accordingly.  Without it ptxas
// gave the bf16 SWA forward 40 registers and it ran 20% slower.
constexpr float LN_EPS = 1e-5f;
// returned by an entry point for arguments its kernels do not take
// (cudaErrorInvalidValue's code)
constexpr int ERR_ARGS = 1;

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------------------
// argument structs (mirrored by ctypes)
// ---------------------------------------------------------------------------

constexpr int NMASK = 13;       // fused_ref.MASK_KEYS
enum MaskKey {
  SWA_ATTN = 0, SWA_PROJ, MSDA_ATTN, MSDA_PROJ, CGA_ATTN, CGA_PROJ,
  CROSS_ATTN, CROSS_PROJ, BN1, BN2, DP1, FFN, DP2
};

struct Dims {
  int B;                  // samples
  int n;                  // tokens per sample (a multiple of NT)
  int side;               // the token grid is side x side
  int nw;                 // SWA windows per sample (WS x WS tokens each)
  int c;                  // embed dim
  int heads;
  int lin_k;              // Linformer compressed length
  int bank_s;             // bank slots
  int msda_keep;          // pooled MSDA rows
  int groups;             // CGA channel groups
  int cperg;              // CGA compressed channels per group
  int ccf_hidden;
  int bottleneck_hidden;
  int d_c;                // per-branch compressed width
  int guard;              // batch-wide NaN guard on the attention outputs
  int stab_ccf;           // LN around the dwconv + gamma
  int stab_dw;            // per-channel dwconv scale
  int dw_bias;            // dwconv bias present
  int grid;               // blocks in the launch
  int train;              // drop-path masks on (training)
  int drop_on;            // dropout masks on (training, rate > 0)
  int rgrid;              // blocks of the reduction pass
  unsigned thr;           // dropout: keep an element when its bits >= thr
  float keep;             // 1 - dropout rate, float32
  unsigned dp_thr;        // drop-path threshold of this block
  float dp_scale;         // 1 / (1 - drop-path rate), float32
  unsigned salt[NMASK];   // one per mask, fused_ref.block_rng
};

// the bank-write projections (frozen; they feed only the bank update)
struct BankWrite {
  const float* norm_s; const float* norm_b;   // write_norm scale, bias
  const float* comp_w; const float* comp_b;   // write_compression
  const float* gate_w; const float* gate_b;   // write_gate
  const float* branch_s; const float* branch_b;  // the branch's own LN
  float* part;            // [grid, 2, S, C] per-block partial sums
  float* part_out;        // [2, S, C] their sum
};

struct SwaArgs {
  const void* x; void* out; void* xn;
  const float* norm1_s; const float* norm1_b;
  const float* qkv_w; const float* qkv_b;
  const float* e_k; const float* e_v;
  const float* bank_k; const float* bank_v;
  const float* proj_w; const float* proj_b;
  int* ws;                // [blocks done, any NaN], zeroed by the caller
  BankWrite bw;           // (train)
  Dims d;
};

struct MsdaArgs {
  const void* xn; void* out;
  const float* sel_t;     // [NT, msda_keep] pooling matrix, transposed
  const float* qkv_w; const float* qkv_b;
  const float* e_k; const float* e_v;
  const float* bank_k; const float* bank_v;
  const float* proj_w; const float* proj_b;
  int* ws;
  BankWrite bw;
  Dims d;
};

struct CgaArgs {
  const void* xn; void* out;
  const float* q_w; const float* q_b;
  const float* k_w; const float* k_b;
  const float* v_w; const float* v_b;
  const float* bk_w; const float* bk_b;
  const float* bv_w; const float* bv_b;
  const float* bank_k; const float* bank_v;
  const float* proj_w; const float* proj_b;
  int* ws;
  BankWrite bw;
  Dims d;
};

struct CrossTailArgs {
  const void* x; const void* xn;
  const void* swa; const void* msda; const void* cga;
  void* y;
  // cross branch
  const float* cq_w; const float* cq_b;
  const float* ck_w; const float* ck_b;
  const float* cv_w; const float* cv_b;
  const float* cp_w; const float* cp_b;
  const float* bank_k; const float* bank_v;
  // tail, branch order swa, msda, cga, cross
  const float* norm_s[4]; const float* norm_b[4];
  const float* comp_w[4]; const float* comp_b[4];
  const float* fusion;    // [4] fusion logits
  const float* bn1_w; const float* bn1_b;
  const float* bn2_w; const float* bn2_b;
  const float* norm2_s; const float* norm2_b;
  const float* fc1_w; const float* fc1_b;
  const float* dwn_s; const float* dwn_b;     // dwconv_norm (stab_ccf)
  const float* dw_w;                          // [hidden, 9]
  const float* dw_b;                          // (dw_bias)
  const float* dw_scale;                      // (stab_dw)
  const float* pdn_s; const float* pdn_b;     // post_dwconv_norm (stab_ccf)
  const float* fc2_w; const float* fc2_b;
  const float* gamma;                         // [1] (stab_ccf)
  int* ws;
  Dims d;
};

// Backward kernels: the forward's argument struct (its inputs; the output
// pointers are unused), the cotangents, and one float pointer per
// gradient into slice 0 of the per-block workspace `gws` ([grid,
// wstride] float32, zeroed by the caller); block i adds into slice i, and
// the reduction pass writes their sum to `grad` ([wstride]).
struct BwdCommon {
  const float* bank_kr;   // bank rows rounded to the working type
  const float* bank_vr;
  const int* flag;        // the forward's ws: flag[1] != 0 = NaN guard tripped
  float* gws;
  float* grad;
  int wstride;
  float* scratch;         // per-block float32 scratch (cross_tail)
};

struct SwaGrads {
  float* norm1_s; float* norm1_b; float* qkv_w; float* qkv_b;
  float* e_k; float* e_v; float* proj_w; float* proj_b;
  float* bank_k; float* bank_v;
};

struct SwaBwdArgs {
  SwaArgs f; BwdCommon c;
  const void* d_out; const void* d_xn;   // cotangents of out, xn
  void* d_x;
  SwaGrads g;
};

struct MsdaGrads {
  float* qkv_w; float* qkv_b; float* e_k; float* e_v;
  float* proj_w; float* proj_b; float* bank_k; float* bank_v;
};

struct MsdaBwdArgs {
  MsdaArgs f; BwdCommon c;
  const void* d_out;
  void* d_xn;
  MsdaGrads g;
};

struct CgaGrads {
  float* q_w; float* q_b; float* k_w; float* k_b; float* v_w; float* v_b;
  float* bk_w; float* bk_b; float* bv_w; float* bv_b;
  float* proj_w; float* proj_b; float* bank_k; float* bank_v;
};

struct CgaBwdArgs {
  CgaArgs f; BwdCommon c;
  const void* d_out;
  void* d_xn;
  CgaGrads g;
};

struct CrossTailGrads {
  float* cq_w; float* cq_b; float* ck_w; float* ck_b;
  float* cv_w; float* cv_b; float* cp_w; float* cp_b;
  float* bank_k; float* bank_v;
  float* norm_s[4]; float* norm_b[4]; float* comp_w[4]; float* comp_b[4];
  float* fusion;
  float* bn1_w; float* bn1_b; float* bn2_w; float* bn2_b;
  float* norm2_s; float* norm2_b; float* fc1_w; float* fc1_b;
  float* dwn_s; float* dwn_b; float* dw_w; float* dw_b; float* dw_scale;
  float* pdn_s; float* pdn_b; float* fc2_w; float* fc2_b; float* gamma;
};

struct CrossTailBwdArgs {
  CrossTailArgs f; BwdCommon c;
  const void* d_y;
  void* d_x; void* d_xn; void* d_swa; void* d_msda; void* d_cga;
  CrossTailGrads g;
};

// ---------------------------------------------------------------------------
// rounding to the working type
// ---------------------------------------------------------------------------

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<bf16>(bf16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);       // round to nearest even
}

template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f<T>(from_f<T>(v));
}


// ---------------------------------------------------------------------------
// training masks: murmur3's finalizer of each element's flat index in the
// JAX package's mask layout (fused_ref.mask_bits computes the same bits)
// ---------------------------------------------------------------------------

__host__ __device__ __forceinline__ unsigned fmix32(unsigned x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ bool kept(unsigned salt, unsigned thr,
                                     unsigned idx) {
  return fmix32(idx * 0x9E3779B1u + salt) >= thr;
}

// inverted dropout of one element of mask `key` (identity unless on)
__device__ __forceinline__ float drop(const Dims& d, int key, unsigned idx,
                                      float v) {
  if (!(d.train && d.drop_on)) return v;
  return kept(d.salt[key], d.thr, idx) ? v / d.keep : 0.f;
}

// prescaled drop-path factor of sample b (1 outside training)
__device__ __forceinline__ float drop_path_mul(const Dims& d, int key,
                                               int b) {
  if (!d.train) return 1.f;
  return kept(d.salt[key], d.dp_thr, (unsigned)b) ? d.dp_scale : 0.f;
}

struct Drop {
  int on;
  unsigned salt, thr;
  float keep;
};

__device__ __forceinline__ Drop attn_drop(const Dims& d, int key) {
  return Drop{d.train && d.drop_on, d.salt[key], d.thr, d.keep};
}

// no dropout: the eval kernels, and the CUDA-core ones of n > NT
__device__ __forceinline__ Drop no_drop() { return Drop{0, 0u, 0u, 1.f}; }

// ---------------------------------------------------------------------------
// block-wide building blocks; callers __syncthreads() between dependent steps
// ---------------------------------------------------------------------------

template <typename T>
__device__ void load_tile(float* dst, const T* src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = to_f<T>(src[i]);
}

template <typename T>
__device__ void store_tile(T* dst, const float* src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = from_f<T>(src[i]);
}

// The NT rows of SWA window w of one sample (src: the sample's [n, c]),
// and back: window w's row r is token (wi * WS + r / WS) * side + wj * WS
// + r % WS, windows and their rows in row-major order over the grid
// (fused_ref.window_partition); with one window the sample's rows as
// they are.
__device__ __forceinline__ int window_base(const Dims& d, int w) {
  const int nh = d.side / WS;          // windows per grid row
  const int wi = w / nh;
  return (wi * d.side + (w - wi * nh)) * WS;
}

template <typename T>
__device__ void load_window(float* dst, const T* src, const Dims& d, int w,
                            int c) {
  if (d.nw == 1) {
    load_tile<T>(dst, src, NT * c);
    return;
  }
  const int base = window_base(d, w);
  for (int i = threadIdx.x; i < NT * c; i += blockDim.x) {
    const int r = i / c;
    const int t = base + (r / WS) * d.side + r % WS;
    dst[i] = to_f<T>(src[(size_t)t * c + (i - r * c)]);
  }
}

template <typename T>
__device__ void store_window(T* dst, const float* src, const Dims& d, int w,
                             int c) {
  if (d.nw == 1) {
    store_tile<T>(dst, src, NT * c);
    return;
  }
  const int base = window_base(d, w);
  for (int i = threadIdx.x; i < NT * c; i += blockDim.x) {
    const int r = i / c;
    const int t = base + (r / WS) * d.side + r % WS;
    dst[(size_t)t * c + (i - r * c)] = from_f<T>(src[i]);
  }
}

// float32 state (the bank) rounded to the working type
template <typename T>
__device__ void load_rounded(float* dst, const float* src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = rnd<T>(src[i]);
}

// LayerNorm of `rows` rows (flax form: float32 statistics, variance
// E[x^2] - mu^2 clamped at 0; with two_pass, mean((x - mu)^2) as jnp.var).
// `in` may equal `out`.  stats: 2*rows floats.
template <typename T>
__device__ void layer_norm_rows(const float* in, int ld_in, float* out,
                                int ld_out, int rows, int cols,
                                const float* __restrict__ scale,
                                const float* __restrict__ bias,
                                float* stats, bool two_pass = false) {
  const int t = threadIdx.x;
  if (t < rows) {
    const float* r = in + t * ld_in;
    float s = 0.f, ss = 0.f;
    for (int c = 0; c < cols; ++c) {
      const float v = r[c];
      s += v;
      ss += v * v;
    }
    const float mu = s / cols;
    float var;
    if (two_pass) {
      float q = 0.f;
      for (int c = 0; c < cols; ++c) q += (r[c] - mu) * (r[c] - mu);
      var = q / cols;
    } else {
      var = fmaxf(ss / cols - mu * mu, 0.f);
    }
    stats[2 * t] = mu;
    stats[2 * t + 1] = rsqrtf(var + LN_EPS);
  }
  __syncthreads();
  for (int i = t; i < rows * cols; i += blockDim.x) {
    const int r = i / cols, c = i - r * cols;
    const float v = (in[r * ld_in + c] - stats[2 * r]) * stats[2 * r + 1];
    out[r * ld_out + c] = rnd<T>(v * scale[c] + bias[c]);
  }
  __syncthreads();
}

// Dense over `rows` <= NT rows (flax nn.Dense, kernel [K, N] row-major
// with leading dim ldw): out = rnd(rnd(in @ rnd(W)) + rnd(bias)).
// With groups > 1 the output columns are groups*N wide; group g reads
// input columns [g*in_gstride, g*in_gstride + K) and shares W (CGA).
// One thread per output column holds all rows' sums; the input rows are
// read as float4 broadcasts, so K, ld_in and in_gstride are multiples of
// 4 and `in` is 16-byte aligned.
template <typename T>
__device__ void dense_rows(const float* in, int ld_in, int in_gstride,
                           int rows, int K, const float* __restrict__ W,
                           int ldw, const float* __restrict__ bias, int N,
                           int groups, float* out, int ld_out) {
  for (int col = threadIdx.x; col < groups * N; col += blockDim.x) {
    const int g = col / N, j = col - g * N;
    const float* inp = in + g * in_gstride;
    float acc[NT];
#pragma unroll
    for (int r = 0; r < NT; ++r) acc[r] = 0.f;
    for (int k = 0; k < K; k += 4) {
      const float w0 = rnd<T>(W[(k + 0) * ldw + j]);
      const float w1 = rnd<T>(W[(k + 1) * ldw + j]);
      const float w2 = rnd<T>(W[(k + 2) * ldw + j]);
      const float w3 = rnd<T>(W[(k + 3) * ldw + j]);
#pragma unroll
      for (int r = 0; r < NT; ++r) {
        if (r < rows) {
          const float4 a = *reinterpret_cast<const float4*>(inp + r * ld_in + k);
          acc[r] = fmaf(a.x, w0, acc[r]);
          acc[r] = fmaf(a.y, w1, acc[r]);
          acc[r] = fmaf(a.z, w2, acc[r]);
          acc[r] = fmaf(a.w, w3, acc[r]);
        }
      }
    }
    const float bj = rnd<T>(bias[j]);
#pragma unroll
    for (int r = 0; r < NT; ++r)
      if (r < rows) out[r * ld_out + col] = rnd<T>(rnd<T>(acc[r]) + bj);
  }
}

// Token mixing out[m, c] = rnd(sum_n rnd(E[n, m]) * in[n, c]) for
// m < mk, n < rows_in (the Linformer E projection and the MSDA pooling).
template <typename T>
__device__ void token_mix(const float* __restrict__ E, int mk, int rows_in,
                          const float* in, int ld_in, int cols, float* out,
                          int ld_out) {
  for (int i = threadIdx.x; i < mk * cols; i += blockDim.x) {
    const int m = i / cols, c = i - m * cols;
    float acc = 0.f;
    for (int n = 0; n < rows_in; ++n)
      acc = fmaf(rnd<T>(E[n * mk + m]), in[n * ld_in + c], acc);
    out[m * ld_out + c] = rnd<T>(acc);
  }
}

__device__ __forceinline__ bool any_nan(const float* p, int rows, int cols,
                                        int ld) {
  for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
    const int r = i / cols;
    if (isnan(p[r * ld + (i - r * cols)])) return true;
  }
  return false;
}

// Softmax attention of nq query rows over VH virtual heads of width D.
// Keys/values: rows [0, na) come from ka/va (leading dim lda, columns
// vh*D...), rows [na, na+nb) from kb/vb (leading dim ldb, columns
// (vh % hb)*D...), which lets CGA's groups share the projected bank.
// out[i, vh*D + dd] (leading dim ldo).  sc: VH*nq*(na+nb) floats, left
// holding the float32 probabilities P; pr (may equal sc) receives the
// probabilities used for PV: rnd(P), or rnd(P / keep) / 0 under the
// dropout mask whose element (vh, i, j) has flat index
// base + (vh*nq + i)*kv + j.  With `guard`, *bad becomes 1 when q, k, v or
// out holds a NaN.
template <typename T>
__device__ void attention(const float* q, int ldq, int nq, int VH, int D,
                          const float* ka, const float* va, int lda, int na,
                          const float* kb, const float* vb, int ldb, int nb,
                          int hb, float* out, int ldo, float* sc, float* pr,
                          Drop dr, unsigned base, int* bad, bool guard) {
  const int kv = na + nb;
  const float sqrt_d = sqrtf((float)D);
  for (int i = threadIdx.x; i < VH * nq * kv; i += blockDim.x) {
    const int vh = i / (nq * kv);
    const int rem = i - vh * nq * kv;
    const int qi = rem / kv, j = rem - qi * kv;
    const float* qr = q + qi * ldq + vh * D;
    const float* kr = j < na ? ka + j * lda + vh * D
                             : kb + (j - na) * ldb + (vh % hb) * D;
    float s = 0.f;
    for (int dd = 0; dd < D; ++dd) s = fmaf(qr[dd], kr[dd], s);
    sc[i] = s / sqrt_d;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < VH * nq; r += blockDim.x) {
    float* row = sc + r * kv;
    float* prow = pr + r * kv;
    float m = -INFINITY;
    for (int j = 0; j < kv; ++j) m = fmaxf(m, row[j]);
    float sum = 0.f;
    for (int j = 0; j < kv; ++j) {
      const float e = expf(row[j] - m);
      row[j] = e;
      sum += e;
    }
    for (int j = 0; j < kv; ++j) {
      const float p = row[j] / sum;
      row[j] = p;
      float v = p;
      if (dr.on)
        v = kept(dr.salt, dr.thr, base + (unsigned)(r * kv + j)) ? p / dr.keep
                                                                 : 0.f;
      prow[j] = rnd<T>(v);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nq * VH * D; i += blockDim.x) {
    const int qi = i / (VH * D), col = i - qi * VH * D;
    const int vh = col / D, dd = col - vh * D;
    const float* p = pr + (vh * nq + qi) * kv;
    float acc = 0.f;
    for (int j = 0; j < na; ++j) acc = fmaf(p[j], va[j * lda + col], acc);
    const int cb = (vh % hb) * D + dd;
    for (int j = 0; j < nb; ++j) acc = fmaf(p[na + j], vb[j * ldb + cb], acc);
    out[qi * ldo + col] = rnd<T>(acc);
  }
  __syncthreads();
  if (guard) {
    const int wb = (hb * D);
    const bool found =
        any_nan(q, nq, VH * D, ldq) || any_nan(out, nq, VH * D, ldo) ||
        any_nan(ka, na, VH * D, lda) || any_nan(va, na, VH * D, lda) ||
        any_nan(kb, nb, wb, ldb) || any_nan(vb, nb, wb, ldb);
    if (found) *bad = 1;
    __syncthreads();
  }
}

__device__ __forceinline__ void fill(float* p, int n, float v) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) p[i] = v;
}

__device__ __forceinline__ float gelu_f(float v) {
  return 0.5f * v * (1.f + erff(v * 0.7071067811865476f));
}

__device__ __forceinline__ float gelu_grad(float v) {
  return 0.5f * (1.f + erff(v * 0.7071067811865476f)) +
         v * 0.3989422804014327f * expf(-0.5f * v * v);
}

template <typename T>
__device__ void gelu_rows(const float* in, float* out, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    out[i] = rnd<T>(gelu_f(in[i]));
}

// The plain version's NaN guard is batch-wide: one NaN anywhere zeroes
// the branch's attention output for every sample.  Blocks cannot wait
// for each other, so each block ORs its own finding into ws[1] and
// counts itself done in ws[0]; the last block to finish reads the
// batch-wide flag and, only if it is set, runs `redo()`, which recomputes
// every sample with the attention output forced to zero.  Without a NaN
// this costs one atomic per block.
template <typename F>
__device__ void finish_guard(int* ws, int bad, F redo) {
  __shared__ int last;
  __shared__ int any;
  __threadfence();        // this thread's output stores before the ticket
  __syncthreads();
  if (threadIdx.x == 0) {
    if (bad) atomicOr(&ws[1], 1);
    __threadfence();
    last = atomicAdd(&ws[0], 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  if (threadIdx.x == 0) {
    __threadfence();
    any = atomicOr(&ws[1], 0);
  }
  __syncthreads();
  if (!any) return;
  redo();
}

// Bank-write partial sums of one sample (fused_ref.bank_write_partial):
// normed = rnd(LN(out; the branch's norm)), t = LN(normed; write_norm)
// with jnp.var's two-pass variance, comp = t @ Wc + bc and gate
// = softmax over the tokens of t @ Wg + bg, all float32; then
// part[0][m, c] += sum_n gate[n, m] comp[n, c] and part[1][m, c] +=
// sum_n gate[n, m] t[n, c] into this block's slice `part` [2, S, C].
// t, comp: NT*c floats; gate: NT*S floats; stats: 2*NT floats.
template <typename T>
__device__ void bank_partials(const float* out, const BankWrite& bw, int c,
                              int S, float* t, float* comp, float* gate,
                              float* stats, float* part) {
  layer_norm_rows<T>(out, c, t, c, NT, c, bw.branch_s, bw.branch_b, stats);
  layer_norm_rows<float>(t, c, t, c, NT, c, bw.norm_s, bw.norm_b, stats,
                         true);
  dense_rows<float>(t, c, 0, NT, c, bw.comp_w, c, bw.comp_b, c, 1, comp, c);
  dense_rows<float>(t, c, 0, NT, c, bw.gate_w, S, bw.gate_b, S, 1, gate, S);
  __syncthreads();
  for (int m = threadIdx.x; m < S; m += blockDim.x) {
    float mx = -INFINITY;
    for (int n = 0; n < NT; ++n) mx = fmaxf(mx, gate[n * S + m]);
    float sum = 0.f;
    for (int n = 0; n < NT; ++n) {
      const float e = expf(gate[n * S + m] - mx);
      gate[n * S + m] = e;
      sum += e;
    }
    for (int n = 0; n < NT; ++n) gate[n * S + m] = gate[n * S + m] / sum;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < S * c; i += blockDim.x) {
    const int m = i / c, col = i - m * c;
    float ak = 0.f, av = 0.f;
    for (int n = 0; n < NT; ++n) {
      ak = fmaf(gate[n * S + m], comp[n * c + col], ak);
      av = fmaf(gate[n * S + m], t[n * c + col], av);
    }
    part[i] += ak;
    part[S * c + i] += av;
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// backward building blocks (float32 cotangents; `acc` adds into dx instead
// of writing it; weight gradients are added to this block's slice)
// ---------------------------------------------------------------------------

// Backward of layer_norm_rows (fast variance): dx from dy; the scale and
// bias gradients are added to g_s / g_b (skipped when null).  dx must
// not alias x or dy.  stats: 4*rows floats.
inline __device__ void layer_norm_bwd_rows(const float* x, int ld_x,
                                           const float* dy, int ld_dy,
                                           float* dx, int ld_dx, bool acc,
                                           int rows, int cols,
                                           const float* __restrict__ scale,
                                           float* g_s, float* g_b,
                                           float* stats) {
  const int t = threadIdx.x;
  if (t < rows) {
    const float* xr = x + t * ld_x;
    const float* dr = dy + t * ld_dy;
    float s = 0.f, ss = 0.f;
    for (int c = 0; c < cols; ++c) {
      s += xr[c];
      ss += xr[c] * xr[c];
    }
    const float mu = s / cols;
    const float vraw = ss / cols - mu * mu;
    const float r = rsqrtf(fmaxf(vraw, 0.f) + LN_EPS);
    float a = 0.f, b = 0.f;
    for (int c = 0; c < cols; ++c) {
      const float g = dr[c] * scale[c];
      a += g;
      b += g * (xr[c] - mu) * r;
    }
    stats[4 * t] = mu;
    stats[4 * t + 1] = r;
    stats[4 * t + 2] = a / cols;
    stats[4 * t + 3] = vraw >= 0.f ? b / cols : 0.f;   // clamp passes no grad
  }
  __syncthreads();
  for (int i = t; i < rows * cols; i += blockDim.x) {
    const int r = i / cols, c = i - r * cols;
    const float* st = stats + 4 * r;
    const float xh = (x[r * ld_x + c] - st[0]) * st[1];
    const float g = dy[r * ld_dy + c] * scale[c];
    const float v = st[1] * (g - st[2] - xh * st[3]);
    float* o = dx + r * ld_dx + c;
    *o = acc ? *o + v : v;
  }
  if (g_s != nullptr) {
    for (int c = t; c < cols; c += blockDim.x) {
      float gs = 0.f, gb = 0.f;
      for (int r = 0; r < rows; ++r) {
        const float d = dy[r * ld_dy + c];
        gs += d * (x[r * ld_x + c] - stats[4 * r]) * stats[4 * r + 1];
        gb += d;
      }
      g_s[c] += gs;
      g_b[c] += gb;
    }
  }
  __syncthreads();
}

// Backward of dense_rows for its input: dx[r, g*out_gstride + k] (+)=
// sum_j dy[r, g*N + j] * rnd(W[k, j]).  One thread per input column holds
// all rows' sums and reads its row of W once, as float4s (N, ldw, ld_dy
// multiples of 4; W and dy 16-byte aligned); dy rows are broadcasts.
template <typename T>
__device__ void dense_dgrad(const float* dy, int ld_dy, int rows, int N,
                            const float* __restrict__ W, int ldw, int K,
                            int groups, int out_gstride, float* dx, int ld_dx,
                            bool acc) {
  for (int col = threadIdx.x; col < groups * K; col += blockDim.x) {
    const int g = col / K, k = col - g * K;
    const float* dyg = dy + g * N;
    const float* w = W + (size_t)k * ldw;
    float a[NT];
#pragma unroll
    for (int r = 0; r < NT; ++r) a[r] = 0.f;
    for (int j = 0; j < N; j += 4) {
      const float4 wv = *reinterpret_cast<const float4*>(w + j);
      const float w0 = rnd<T>(wv.x), w1 = rnd<T>(wv.y);
      const float w2 = rnd<T>(wv.z), w3 = rnd<T>(wv.w);
#pragma unroll
      for (int r = 0; r < NT; ++r) {
        if (r < rows) {
          const float4 d =
              *reinterpret_cast<const float4*>(dyg + r * ld_dy + j);
          a[r] = fmaf(d.x, w0, a[r]);
          a[r] = fmaf(d.y, w1, a[r]);
          a[r] = fmaf(d.z, w2, a[r]);
          a[r] = fmaf(d.w, w3, a[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < NT; ++r) {
      if (r < rows) {
        float* o = dx + r * ld_dx + g * out_gstride + k;
        *o = acc ? *o + a[r] : a[r];
      }
    }
  }
}

// Backward of dense_rows for its weights: gW[k, j] += sum_g sum_r
// in[r, g*in_gstride + k] * dy[r, g*N + j] (leading dim ldg) and
// gb[j] += sum_g sum_r dy[r, g*N + j] (skipped when gb is null).  gW is
// this block's slice in device memory: each thread loads the old values
// of four elements before it sums them, so four loads are in flight.
inline __device__ void dense_wgrad(const float* in, int ld_in, int in_gstride,
                                   int rows, int K, const float* dy,
                                   int ld_dy, int N, int groups, float* gW,
                                   int ldg, float* gb) {
  const int total = K * N, step = blockDim.x;
  for (int i0 = threadIdx.x; i0 < total; i0 += 4 * step) {
    float old[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * step;
      if (i < total) old[u] = gW[(i / N) * ldg + i % N];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * step;
      if (i < total) {
        const int k = i / N, j = i - k * N;
        float a = 0.f;
        for (int g = 0; g < groups; ++g)
          for (int r = 0; r < rows; ++r)
            a = fmaf(in[r * ld_in + g * in_gstride + k],
                     dy[r * ld_dy + g * N + j], a);
        gW[k * ldg + j] = old[u] + a;
      }
    }
  }
  if (gb != nullptr) {
    for (int j = threadIdx.x; j < N; j += blockDim.x) {
      float a = 0.f;
      for (int g = 0; g < groups; ++g)
        for (int r = 0; r < rows; ++r) a += dy[r * ld_dy + g * N + j];
      gb[j] += a;
    }
  }
}

// Backward of token_mix: din[n, c] (+)= sum_m rnd(E[n, m]) dout[m, c]
// (n < rows_in) and, when gE is not null, first gE[n, m] += sum_c
// in[n, c] dout[m, c]; din may alias in.
template <typename T>
__device__ void token_mix_bwd(const float* __restrict__ E, int mk,
                              int rows_in, const float* in, int ld_in,
                              const float* dout, int ld_out, int cols,
                              float* din, int ld_din, bool acc, float* gE) {
  if (gE != nullptr) {
    for (int i = threadIdx.x; i < rows_in * mk; i += blockDim.x) {
      const int n = i / mk, m = i - n * mk;
      float a = 0.f;
      for (int c = 0; c < cols; ++c)
        a = fmaf(in[n * ld_in + c], dout[m * ld_out + c], a);
      gE[i] += a;
    }
    __syncthreads();      // din may overwrite in
  }
  for (int i = threadIdx.x; i < rows_in * cols; i += blockDim.x) {
    const int n = i / cols, c = i - n * cols;
    float a = 0.f;
    for (int m = 0; m < mk; ++m)
      a = fmaf(rnd<T>(E[n * mk + m]), dout[m * ld_out + c], a);
    float* o = din + n * ld_din + c;
    *o = acc ? *o + a : a;
  }
  __syncthreads();
}

// Backward of attention() given dO (leading dim ldo).  sc holds P, pr
// the probabilities used for PV, as attention() left them; dp is
// scratch of VH*nq*kv floats.  Writes dka/dva (rows < na, leading dim
// ldda; dva may alias va) and dq (may alias q); adds into dkb/dvb
// (rows < nb, hb*D columns, leading dim lddb), summing over the virtual
// heads that share a bank head.
template <typename T>
__device__ void attention_bwd(const float* q, int ldq, int nq, int VH, int D,
                              const float* ka, const float* va, int lda,
                              int na, const float* kb, const float* vb,
                              int ldb, int nb, int hb, const float* dO,
                              int ldo, const float* sc, const float* pr,
                              float* dp, Drop dr, unsigned base, float* dq,
                              int lddq, float* dka, float* dva, int ldda,
                              float* dkb, float* dvb, int lddb) {
  const int kv = na + nb;
  const float sqrt_d = sqrtf((float)D);
  // dP = dO V^T, through the dropout mask
  for (int i = threadIdx.x; i < VH * nq * kv; i += blockDim.x) {
    const int vh = i / (nq * kv);
    const int rem = i - vh * nq * kv;
    const int qi = rem / kv, j = rem - qi * kv;
    const float* o = dO + qi * ldo + vh * D;
    const float* vr = j < na ? va + j * lda + vh * D
                             : vb + (j - na) * ldb + (vh % hb) * D;
    float s = 0.f;
    for (int dd = 0; dd < D; ++dd) s = fmaf(o[dd], vr[dd], s);
    if (dr.on)
      s = kept(dr.salt, dr.thr, base + (unsigned)i) ? s / dr.keep : 0.f;
    dp[i] = s;
  }
  __syncthreads();
  // dV = pr^T dO
  for (int i = threadIdx.x; i < na * VH * D; i += blockDim.x) {
    const int j = i / (VH * D), col = i - j * VH * D;
    const int vh = col / D;
    float a = 0.f;
    for (int qi = 0; qi < nq; ++qi)
      a = fmaf(pr[(vh * nq + qi) * kv + j], dO[qi * ldo + col], a);
    dva[j * ldda + col] = a;
  }
  for (int i = threadIdx.x; i < nb * hb * D; i += blockDim.x) {
    const int j = i / (hb * D), cb = i - j * hb * D;
    const int hh = cb / D, dd = cb - hh * D;
    float a = 0.f;
    for (int vh = hh; vh < VH; vh += hb)
      for (int qi = 0; qi < nq; ++qi)
        a = fmaf(pr[(vh * nq + qi) * kv + na + j], dO[qi * ldo + vh * D + dd],
                 a);
    dvb[j * lddb + cb] += a;
  }
  // softmax backward, in place: dS = P (dP - sum(dP P)) / sqrt(D)
  for (int r = threadIdx.x; r < VH * nq; r += blockDim.x) {
    float* row = dp + r * kv;
    const float* p = sc + r * kv;
    float dot = 0.f;
    for (int j = 0; j < kv; ++j) dot = fmaf(row[j], p[j], dot);
    for (int j = 0; j < kv; ++j) row[j] = p[j] * (row[j] - dot) / sqrt_d;
  }
  __syncthreads();
  // dK = dS^T q
  for (int i = threadIdx.x; i < na * VH * D; i += blockDim.x) {
    const int j = i / (VH * D), col = i - j * VH * D;
    const int vh = col / D;
    float a = 0.f;
    for (int qi = 0; qi < nq; ++qi)
      a = fmaf(dp[(vh * nq + qi) * kv + j], q[qi * ldq + col], a);
    dka[j * ldda + col] = a;
  }
  for (int i = threadIdx.x; i < nb * hb * D; i += blockDim.x) {
    const int j = i / (hb * D), cb = i - j * hb * D;
    const int hh = cb / D, dd = cb - hh * D;
    float a = 0.f;
    for (int vh = hh; vh < VH; vh += hb)
      for (int qi = 0; qi < nq; ++qi)
        a = fmaf(dp[(vh * nq + qi) * kv + na + j], q[qi * ldq + vh * D + dd],
                 a);
    dkb[j * lddb + cb] += a;
  }
  __syncthreads();
  // dq = dS K
  for (int i = threadIdx.x; i < nq * VH * D; i += blockDim.x) {
    const int qi = i / (VH * D), col = i - qi * VH * D;
    const int vh = col / D, dd = col - vh * D;
    const float* s = dp + (vh * nq + qi) * kv;
    float a = 0.f;
    for (int j = 0; j < na; ++j) a = fmaf(s[j], ka[j * lda + col], a);
    const int cb = (vh % hb) * D + dd;
    for (int j = 0; j < nb; ++j) a = fmaf(s[na + j], kb[j * ldb + cb], a);
    dq[qi * lddq + col] = a;
  }
  __syncthreads();
}

// this block's slice of a per-block gradient workspace (null stays null)
__device__ __forceinline__ float* slice(float* p, const BwdCommon& c) {
  return p == nullptr ? nullptr : p + (size_t)blockIdx.x * c.wstride;
}

// out[k] = the block-wide sum of every thread's v[k] (k < n), summed in
// thread order; red: n * NTHREADS floats of scratch
inline __device__ void block_sum(const float* v, int n, float* red,
                                 float* out) {
  for (int k = 0; k < n; ++k) red[k * NTHREADS + threadIdx.x] = v[k];
  __syncthreads();
  if ((int)threadIdx.x < n) {
    float s = 0.f;
    for (int t = 0; t < NTHREADS; ++t) s += red[threadIdx.x * NTHREADS + t];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

// dropout backward over n elements in place: d = drop(d) (mask / keep)
inline __device__ void drop_rows(const Dims& d, int key, unsigned base,
                                 float* p, int n) {
  if (!(d.train && d.drop_on)) return;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    p[i] = drop(d, key, base + (unsigned)i, p[i]);
}

__host__ __device__ inline int pad4(int n) { return ((n + 3) / 4) * 4; }

// out[i] = sum over p < P of ws[p*n + i], in order of p
static __global__ void __launch_bounds__(NTHREADS)
    reduce_rows_kernel(const float* ws, float* out, int P, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < P; ++p) s += ws[(size_t)p * n + i];
    out[i] = s;
  }
}

}  // namespace qv

#ifndef QV_EMULATE
// Launch a unit kernel with `smem_bytes` of dynamic shared memory on
// `grid` blocks; returns the launch's cudaGetLastError().
template <typename A>
static int qv_launch(void (*kernel)(A), const A& a, size_t smem_bytes,
                     void* stream, int grid) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, qv::NTHREADS, smem_bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The fixed-order reduction pass over per-block partial sums.
static int qv_reduce(const float* ws, float* out, int P, int n, int grid,
                     void* stream) {
  qv::reduce_rows_kernel<<<grid, qv::NTHREADS, 0, (cudaStream_t)stream>>>(
      ws, out, P, n);
  return (int)cudaGetLastError();
}
#else
static int qv_reduce(const float* ws, float* out, int P, int n, int grid,
                     void*) {
  return qv_emu_run(grid, [&] { qv::reduce_rows_kernel(ws, out, P, n); });
}
#endif
