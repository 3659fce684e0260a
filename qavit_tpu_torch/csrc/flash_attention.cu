// Small-KV attention: softmax(q k^T / sqrt(D)) v with optional probability
// dropout, one full softmax per query row.
//
// Replaces the TPU kernel qavit_tpu/kernels/flash_attention.py:74
// flash_attention (pallas_call :122, body _attn_kernel :36-71), which the
// attention dispatch runs for n_q >= 128 and head_dim >= 32: the MSDA and
// cross attentions of the flat QAViT at 224 (196 queries against 80 and 16
// keys, 4 heads of 48).  As on the TPU the whole key set of a (batch,
// head) slice fits on chip (16-144 keys, D 32-64), so there is no online
// softmax: the scores of a row are taken in full, then its max and sum.
//
// Layout: q [B, Nq, H, D], k and v [B, Nkv, H, D], read in place through
// their element strides over (b, n, h) (the last axis is contiguous; a
// stride of 0 over b serves a key set broadcast over the batch, as the
// cross branch's bank keys are); o [B, Nq, H, D] contiguous, in q's type.
//
// Design: one 256-thread block per (b*h, tile of FA_QT queries).  The
// block stages its slice's K and V once in shared memory as float32 (rows
// padded to D + 1 floats, so the lanes of a warp reading one column of
// consecutive rows hit distinct banks).  Each warp takes one query row at
// a time: lane j scores keys j, j + 32, ... (float32 FMAs, times the
// float32 scale), the warp reduces max and sum by shuffles, each
// probability p = e / sum is dropped where the counter hash says so
// (p / keep), rounded to v's type as the plain version rounds it, and
// written to the warp's row of shared memory; then lane d accumulates
// o[d] = sum_j p_j v[j, d] in float32 and stores it in o's type.
//
// Dropout: the TPU kernel seeds its own PRNG per grid step, which nothing
// off the TPU can replay.  Here element (b, h, i, j) of the [B, H, Nq, Nkv]
// probabilities is kept when fmix32(idx * 0x9E3779B1 + salt) >= thr, idx
// its flat index (common.cuh's `kept`, fused_ref.mask_bits in torch), so
// the plain version replays the exact mask.
//
// Bound on the H100 at the 224 MSDA shape, B=256, bf16: 19.3 MB of q and o
// plus 2 x 7.9 MB of k and v (~0.016 ms at 3.35 TB/s) against 3.1 GFLOP;
// the bytes bound it.  This first version runs the products on the CUDA
// cores in float32 (67 TFLOP/s), not the tensor cores: a later PR's work.
#include "common.cuh"

namespace qv {

struct FlashArgs {
  const void* q; const void* k; const void* v; void* o;
  long long q_sb, q_sn, q_sh;     // element strides of q over b, n, h
  long long k_sb, k_sn, k_sh;
  long long v_sb, v_sn, v_sh;
  int B, H, nq, nkv, d;
  int q_tiles;                    // ceil(nq / FA_QT)
  float scale;                    // 1 / sqrt(d) as float32
  int drop_on;                    // probability dropout on
  unsigned thr;                   // keep an element when its bits >= thr
  float keep;                     // 1 - rate, float32
  unsigned salt;
};

constexpr int FA_WARPS = NTHREADS / 32;
constexpr int FA_QT = 64;                       // queries per block
constexpr int FA_MAX_KV = 144, FA_MIN_KV = 16;  // keys per slice
constexpr int FA_MAX_D = 64, FA_MIN_D = 32;
constexpr int FA_KV_PER_LANE = (FA_MAX_KV + 31) / 32;

__host__ __device__ inline int flash_smem_floats(const FlashArgs& a) {
  return 2 * a.nkv * (a.d + 1)      // K, V rows, padded
         + FA_WARPS * a.d           // each warp's query row
         + FA_WARPS * a.nkv;        // each warp's probabilities
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS) flash_kernel(FlashArgs a) {
  QV_SMEM_DECL
  const int nkv = a.nkv, D = a.d, ld = D + 1;
  const int bh = blockIdx.x / a.q_tiles, tile = blockIdx.x % a.q_tiles;
  const int b = bh / a.H, h = bh % a.H;
  float* ks = qv_smem;
  float* vs = ks + nkv * ld;
  float* qs = vs + nkv * ld;
  float* ps = qs + FA_WARPS * D;

  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  for (int i = threadIdx.x; i < nkv * D; i += blockDim.x) {
    const int j = i / D, e = i - j * D;
    ks[j * ld + e] = to_f<T>(kp[j * a.k_sn + e]);
    vs[j * ld + e] = to_f<T>(vp[j * a.v_sn + e]);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* qw = qs + warp * D;
  float* pw = ps + warp * nkv;
  for (int r = warp; r < FA_QT; r += FA_WARPS) {
    const int i = tile * FA_QT + r;
    if (i >= a.nq) break;                        // the same for the warp
    const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + i * a.q_sn +
                  h * a.q_sh;
    for (int e = lane; e < D; e += 32) qw[e] = to_f<T>(qp[e]);
    __syncwarp();

    float s[FA_KV_PER_LANE];
    float m = -INFINITY;
#pragma unroll
    for (int t = 0; t < FA_KV_PER_LANE; ++t) {
      const int j = lane + 32 * t;
      s[t] = 0.f;
      if (j < nkv) {
        const float* kr = ks + j * ld;
        float acc = 0.f;
        for (int e = 0; e < D; ++e) acc = fmaf(qw[e], kr[e], acc);
        s[t] = acc * a.scale;
        m = fmaxf(m, s[t]);
      }
    }
    m = warp_max(m);
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < FA_KV_PER_LANE; ++t) {
      if (lane + 32 * t < nkv) {
        s[t] = expf(s[t] - m);
        sum += s[t];
      }
    }
    sum = warp_sum(sum);
    const unsigned row = ((unsigned)bh * (unsigned)a.nq + (unsigned)i) *
                         (unsigned)nkv;
#pragma unroll
    for (int t = 0; t < FA_KV_PER_LANE; ++t) {
      const int j = lane + 32 * t;
      if (j < nkv) {
        float p = s[t] / sum;
        if (a.drop_on)
          p = kept(a.salt, a.thr, row + (unsigned)j) ? p / a.keep : 0.f;
        pw[j] = rnd<T>(p);
      }
    }
    __syncwarp();

    T* op = static_cast<T*>(a.o) + (((size_t)b * a.nq + i) * a.H + h) * D;
    for (int e = lane; e < D; e += 32) {
      float acc = 0.f;
      for (int j = 0; j < nkv; ++j) acc = fmaf(pw[j], vs[j * ld + e], acc);
      op[e] = from_f<T>(acc);
    }
    __syncwarp();                  // qw, pw are rewritten for the next row
  }
}

}  // namespace qv

// Returns 0, the launch's CUDA error, or -1 for a shape outside the range
// the kernel was written for (the wrapper checks it first).
extern "C" int qv_flash_attention(const qv::FlashArgs* a, int is_bf16,
                                  void* stream) {
  if (a->nkv < qv::FA_MIN_KV || a->nkv > qv::FA_MAX_KV ||
      a->d < qv::FA_MIN_D || a->d > qv::FA_MAX_D || a->nq < 1 ||
      a->q_tiles != (a->nq + qv::FA_QT - 1) / qv::FA_QT)
    return -1;
  const size_t smem = qv::flash_smem_floats(*a) * sizeof(float);
  const int grid = a->B * a->H * a->q_tiles;
  return is_bf16 ? qv_launch(qv::flash_kernel<qv::bf16>, *a, smem, stream,
                             grid)
                 : qv_launch(qv::flash_kernel<float>, *a, smem, stream, grid);
}

extern "C" int qv_flash_struct_size() { return (int)sizeof(qv::FlashArgs); }
