// Shared pieces of the fused-block unit kernels (eval forward).
//
// Every unit kernel runs one thread block per sample: the sample's 16
// tokens, its intermediates and its attention scores stay in shared
// memory as float32; weights are float32 in device memory and stay in L2
// across the grid.  Values are rounded to the working type (float or
// bf16) at the points where the plain PyTorch version
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

constexpr int NT = 16;          // tokens per sample (the 4x4 learned grid)
constexpr int NTHREADS = 256;   // threads per block
constexpr float LN_EPS = 1e-5f;

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------------------
// argument structs (mirrored by ctypes)
// ---------------------------------------------------------------------------

struct Dims {
  int B;                  // samples = blocks in the grid
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
};

struct SwaArgs {
  const void* x; void* out; void* xn;
  const float* norm1_s; const float* norm1_b;
  const float* qkv_w; const float* qkv_b;
  const float* e_k; const float* e_v;
  const float* bank_k; const float* bank_v;
  const float* proj_w; const float* proj_b;
  int* ws;                // [blocks done, any NaN], zeroed by the caller
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

// float32 state (the bank) rounded to the working type
template <typename T>
__device__ void load_rounded(float* dst, const float* src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = rnd<T>(src[i]);
}

// LayerNorm of `rows` rows (flax form: float32 statistics, variance
// E[x^2] - mu^2 clamped at 0).  `in` may equal `out`.  stats: 2*rows floats.
template <typename T>
__device__ void layer_norm_rows(const float* in, int ld_in, float* out,
                                int ld_out, int rows, int cols,
                                const float* __restrict__ scale,
                                const float* __restrict__ bias,
                                float* stats) {
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
    const float var = fmaxf(ss / cols - mu * mu, 0.f);
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
// out[i, vh*D + dd] (leading dim ldo).  sc: VH*nq*(na+nb) floats.
// Scores and softmax in float32, probabilities rounded to the working
// type before PV.  With `guard`, *bad becomes 1 when q, k, v or out
// holds a NaN (bad is reset by the caller).
template <typename T>
__device__ void attention(const float* q, int ldq, int nq, int VH, int D,
                          const float* ka, const float* va, int lda, int na,
                          const float* kb, const float* vb, int ldb, int nb,
                          int hb, float* out, int ldo, float* sc, int* bad,
                          bool guard) {
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
    float m = -INFINITY;
    for (int j = 0; j < kv; ++j) m = fmaxf(m, row[j]);
    float sum = 0.f;
    for (int j = 0; j < kv; ++j) {
      const float e = expf(row[j] - m);
      row[j] = e;
      sum += e;
    }
    for (int j = 0; j < kv; ++j) row[j] = rnd<T>(row[j] / sum);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nq * VH * D; i += blockDim.x) {
    const int qi = i / (VH * D), col = i - qi * VH * D;
    const int vh = col / D, dd = col - vh * D;
    const float* p = sc + (vh * nq + qi) * kv;
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

// The plain version's NaN guard is batch-wide: one NaN anywhere zeroes
// the branch's attention output for every sample.  Blocks cannot wait
// for each other, so each block ORs its own finding into ws[1] and
// counts itself done in ws[0]; the last block to finish reads the
// batch-wide flag and, only if it is set, recomputes every sample with
// the attention output forced to zero (`redo(b)`).  Without a NaN this
// costs one atomic per block.
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
  for (int b = 0; b < (int)gridDim.x; ++b) redo(b);
}

}  // namespace qv

#ifndef QV_EMULATE
// Launch `kernel` with `smem_bytes` of dynamic shared memory, one block
// per sample; returns the launch's cudaGetLastError().
template <typename A>
static int qv_launch(void (*kernel)(A), const A& a, size_t smem_bytes,
                     void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<a.d.B, qv::NTHREADS, smem_bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
#endif
