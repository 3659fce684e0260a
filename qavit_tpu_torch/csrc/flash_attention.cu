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
// Dropout: the TPU kernel seeds its own PRNG per grid step, which nothing
// off the TPU can replay.  Here element (b, h, i, j) of the [B, H, Nq, Nkv]
// probabilities is kept when fmix32(idx * 0x9E3779B1 + salt) >= thr, idx
// its flat index (common.cuh's `kept`, fused_ref.mask_bits in torch), so
// the plain version replays the exact mask.
//
// Bound on the H100 at the 224 MSDA shape, B=256, bf16: 19.3 MB of q and o
// plus 2 x 7.9 MB of k and v (~0.016 ms at 3.35 TB/s) against 3.1 GFLOP
// (~0.003 ms at 989 TFLOP/s): the bytes bound it, at the cross shape (16
// keys) too.
//
// bf16: flash_mma_kernel, on the tensor cores, as the TPU kernel feeds its
// MXU bf16 operands with float32 accumulation.  One 256-thread block per
// (b, h, chunk of FA_MMA_QT = 128 queries); each warp owns one 16-query
// tile.  The block stages its slice's K and V once in shared memory as
// bf16 (Nkv and D zero-padded to multiples of 16, rows padded by 8 so
// ldmatrix's eight row reads hit distinct banks) with cp.async, each warp
// its Q tile beside them.  S = Q K^T runs on mma.sync m16n8k16 (ldmatrix
// for Q and K); the scores stay in registers (Nkv / 8 tiles of 4 floats a
// thread); padded keys get -inf; row max and sum are quad shuffles in
// float32; each probability is dropped by its (b, h, i, j) hash and
// rounded to bf16 where the plain version rounds it, straight into the A
// fragments of PV (mma.cuh), which reads V through ldmatrix.trans.
//
// What bounds it: at these shapes not the bytes (0.016 ms) but the
// instructions of the softmax, ~40 scores a thread in a 16-query tile,
// where a division or an expf per score costs more issue slots than the
// tensor-core work.  So p = e times the sum's reciprocal, and one FMA
// folds the float32 scale, log2(e) and the max into exp2f's argument: p
// moves by float32 roundoff only, far below its rounding to bf16, which
// stays where the plain version puts it.  Every byte of q, k, v and o
// crosses device memory once per query chunk (k and v twice at 196
// queries, the second time from L2).  Loads: a row whose start is
// 16-byte aligned (base, strides and D multiples of 8 elements) goes by
// cp.async, any other operand by plain loads; every shape of
// chip_smoke's FLASH_SHAPES (D 48 or 64, strides multiples of 48, the
// cross keys' stride-0 batch) takes cp.async.
//
// Time at B=256 on an NVIDIA H100 80GB HBM3, 700.00 W (chip_smoke.py phase
// i, PERF.md section 6 row 9): 0.064 ms on the device at the MSDA shape
// and 0.033 ms at the cross shape (0.060-0.073 ms per call, which the
// wrapper's host work sets), against 0.558-0.561 / 0.181-0.183 ms for the
// CUDA-core kernel in the same run and 0.042-0.053 ms for
// scaled_dot_product_attention.
//
// float32: flash_kernel, the CUDA-core kernel (the tensor cores' TF32
// keeps too few digits for the 1e-4 tolerance).  One 256-thread block per
// (b*h, tile of FA_QT queries).  The block stages its slice's K and V once
// in shared memory (rows padded to D + 1 floats, so the lanes of a warp
// reading one column of consecutive rows hit distinct banks).  Each warp
// takes one query row at a time: lane j scores keys j, j + 32, ... (FMAs,
// times the scale), the warp reduces max and sum by shuffles, each
// probability p = e / sum is dropped where the counter hash says so
// (p / keep) and written to the warp's row of shared memory; then lane d
// accumulates o[d] = sum_j p_j v[j, d] and stores it.
#include "mma.cuh"

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

// --- bf16: the tensor-core kernel ------------------------------------------

constexpr int FA_MMA_QT = 16 * FA_WARPS;    // queries per block, 16 a warp

// shared-memory row of a head: D padded to 16, plus 8 so the rows that one
// ldmatrix reads start in distinct banks
__host__ __device__ inline int flash_mma_ld(int d) {
  return (d + 15) / 16 * 16 + 8;
}

__host__ __device__ inline int flash_mma_smem_bytes(const FlashArgs& a) {
  return (2 * ((a.nkv + 15) / 16 * 16) + FA_MMA_QT) * flash_mma_ld(a.d) *
         (int)sizeof(bf16);
}

// every row of the operand starts on 16 bytes, so cp.async can take it
__device__ __forceinline__ bool rows_aligned16(const void* p, long long sb,
                                               long long sn, long long sh,
                                               int d) {
  return (size_t)p % 16 == 0 && sb % 8 == 0 && sn % 8 == 0 && sh % 8 == 0 &&
         d % 8 == 0;
}

// dst[r, c] (leading dim ld) for r < rows, c < dp: src's row r (stride sn)
// where r < n and c < d, else 0; by cp.async when `vec`, else by plain
// loads.  Threads t0, t0 + nt, ... share the work; only the padding is
// written with zeros.
__device__ __forceinline__ void stage_rows(bf16* dst, int ld, const bf16* src,
                                           long long sn, int n, int d,
                                           int rows, int dp, bool vec, int t0,
                                           int nt) {
  if (vec) {          // (r, c) walks the 16-byte chunks without dividing
    const int cpr = d / 8, dr = nt / cpr, dc = nt - dr * cpr;
    int r = t0 / cpr, c = t0 - r * cpr;
    while (r < n) {
      cp_async_16(dst + r * ld + 8 * c, src + r * sn + 8 * c);
      r += dr;
      c += dc;
      if (c >= cpr) {
        c -= cpr;
        ++r;
      }
    }
  } else {
    for (int i = t0; i < n * d; i += nt) {
      const int r = i / d, c = i - r * d;
      dst[r * ld + c] = src[r * sn + c];
    }
  }
  const bf16 zero = from_f<bf16>(0.f);
  const int pc = dp - d;
  for (int i = t0; i < n * pc; i += nt) {
    const int r = i / pc;
    dst[r * ld + d + (i - r * pc)] = zero;
  }
  for (int i = t0; i < (rows - n) * dp; i += nt) {
    const int r = i / dp;
    dst[(n + r) * ld + (i - r * dp)] = zero;
  }
}

// NK16, KD: the most 16-key tiles and 16-wide head steps this instance
// takes (its register arrays); nkv and d are runtime values within them
template <int NK16, int KD>
__global__ void __launch_bounds__(NTHREADS, NK16 <= 6 ? 2 : 1)
    flash_mma_kernel(FlashArgs a) {
  QV_SMEM_DECL
  const int nkv = a.nkv, D = a.d;
  const int nk16 = (nkv + 15) / 16, kd = (D + 15) / 16;
  const int ld = flash_mma_ld(D);
  const int chunks = (a.nq + FA_MMA_QT - 1) / FA_MMA_QT;
  const int bh = blockIdx.x / chunks, chunk = blockIdx.x - bh * chunks;
  const int b = bh / a.H, h = bh - b * a.H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int i0 = chunk * FA_MMA_QT + warp * 16;     // the warp's first query
  bf16* ks = reinterpret_cast<bf16*>(qv_smem);
  bf16* vs = ks + 16 * nk16 * ld;
  bf16* qs = vs + 16 * nk16 * ld + warp * 16 * ld;

  const bf16* kp = static_cast<const bf16*>(a.k) + b * a.k_sb + h * a.k_sh;
  const bf16* vp = static_cast<const bf16*>(a.v) + b * a.v_sb + h * a.v_sh;
  stage_rows(ks, ld, kp, a.k_sn, nkv, D, 16 * nk16, 16 * kd,
             rows_aligned16(a.k, a.k_sb, a.k_sn, a.k_sh, D), threadIdx.x,
             blockDim.x);
  stage_rows(vs, ld, vp, a.v_sn, nkv, D, 16 * nk16, 16 * kd,
             rows_aligned16(a.v, a.v_sb, a.v_sn, a.v_sh, D), threadIdx.x,
             blockDim.x);
  if (i0 < a.nq) {
    const bf16* qp = static_cast<const bf16*>(a.q) + b * a.q_sb +
                     (long long)i0 * a.q_sn + h * a.q_sh;
    const int rows = a.nq - i0 < 16 ? a.nq - i0 : 16;
    stage_rows(qs, ld, qp, a.q_sn, rows, D, 16, 16 * kd,
               rows_aligned16(a.q, a.q_sb, a.q_sn, a.q_sh, D), lane, 32);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (i0 >= a.nq) return;                          // the same for the warp

  const int g = lane >> 2, t = lane & 3;
  // S = Q K^T: per thread rows g and g + 8 of 2 * nk16 tiles of 8 keys
  unsigned qa[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
    if (kk < kd) load_a(qa[kk], qs + kk * 16, ld, lane);
  float s[2 * NK16][4];
#pragma unroll
  for (int j = 0; j < 2 * NK16; ++j)
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
    for (int np = 0; np < NK16; ++np) {
      if (kk < kd && np < nk16) {
        unsigned kb[4];
        load_b_nk(kb, ks + np * 16 * ld + kk * 16, ld, lane);
        mma_bf16_16816(s[2 * np], qa[kk], kb);
        mma_bf16_16816(s[2 * np + 1], qa[kk], kb + 2);
      }
    }
  }

  // softmax in float32 over each row's keys (a quad holds a row).  Keys
  // past nkv are padding: -inf, as the TPU kernel masks col < n_kv.  The
  // scores are taken times the float32 scale, with log2(e) folded in so
  // that one FMA and exp2f do the work of the scaling, the max's
  // subtraction and expf; p = e times the sum's reciprocal.  These move p
  // by float32 roundoff only, far below its rounding to bf16.
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < 2 * NK16; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool in = j < 2 * nk16 && 8 * j + 2 * t + e < nkv;
      s[j][e] = in ? s[j][e] : -INFINITY;
      s[j][2 + e] = in ? s[j][2 + e] : -INFINITY;
      m0 = fmaxf(m0, s[j][e]);
      m1 = fmaxf(m1, s[j][2 + e]);
    }
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
  }
  const float c2 = a.scale * 1.4426950408889634f;   // scale x log2(e)
  const float mc0 = -m0 * c2, mc1 = -m1 * c2;
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int j = 0; j < 2 * NK16; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[j][e] = exp2f(fmaf(s[j][e], c2, mc0));
      s[j][2 + e] = exp2f(fmaf(s[j][2 + e], c2, mc1));
      l0 += s[j][e];
      l1 += s[j][2 + e];
    }
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }
  const float r0 = 1.f / l0, r1 = 1.f / l1;
#pragma unroll
  for (int j = 0; j < 2 * NK16; ++j) {
    s[j][0] *= r0;
    s[j][1] *= r0;
    s[j][2] *= r1;
    s[j][3] *= r1;
  }
  if (a.drop_on) {   // p dropped by the hash of its flat (b, h, i, j) index
    const unsigned row0 =
        ((unsigned)bh * (unsigned)a.nq + (unsigned)(i0 + g)) * (unsigned)nkv;
    const unsigned row1 = row0 + 8u * (unsigned)nkv;
#pragma unroll
    for (int j = 0; j < 2 * NK16; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const unsigned idx =
            (e < 2 ? row0 : row1) + (unsigned)(8 * j + 2 * t + (e & 1));
        s[j][e] = kept(a.salt, a.thr, idx) ? s[j][e] / a.keep : 0.f;
      }
    }
  }

  // O = rnd(P) V: the rounded probabilities of two key tiles are the A
  // fragment of one 16-key step
  float o[2 * KD][4];
#pragma unroll
  for (int j = 0; j < 2 * KD; ++j)
    o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < NK16; ++kk) {
    if (kk < nk16) {
      const unsigned pa[4] = {
          pack_bf16x2(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < KD; ++dp) {
        if (dp < kd) {
          unsigned vb[4];
          load_b_kn(vb, vs + kk * 16 * ld + dp * 16, ld, lane);
          mma_bf16_16816(o[2 * dp], pa, vb);
          mma_bf16_16816(o[2 * dp + 1], pa, vb + 2);
        }
      }
    }
  }

  const size_t o_row = (size_t)a.H * D;
  bf16* op = static_cast<bf16*>(a.o) + (((size_t)b * a.nq + i0) * a.H + h) * D;
#pragma unroll
  for (int j = 0; j < 2 * KD; ++j) {
    const int col = 8 * j + 2 * t;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = g + 8 * hf;
      if (j < 2 * kd && col < D && i0 + r < a.nq) {
        bf16* dst = op + r * o_row + col;
        if (D % 2 == 0) {
          store_bf16x2(dst, pack_bf16x2(o[j][2 * hf], o[j][2 * hf + 1]));
        } else {
          dst[0] = from_f<bf16>(o[j][2 * hf]);
          if (col + 1 < D) dst[1] = from_f<bf16>(o[j][2 * hf + 1]);
        }
      }
    }
  }
}

}  // namespace qv

extern "C" int qv_flash_smem(const qv::FlashArgs* a, int is_bf16);

// Returns 0, the launch's CUDA error, or -1 for a shape outside the range
// the kernel was written for (the wrapper checks it first).
extern "C" int qv_flash_attention(const qv::FlashArgs* a, int is_bf16,
                                  void* stream) {
  if (a->nkv < qv::FA_MIN_KV || a->nkv > qv::FA_MAX_KV ||
      a->d < qv::FA_MIN_D || a->d > qv::FA_MAX_D || a->nq < 1 ||
      a->q_tiles != (a->nq + qv::FA_QT - 1) / qv::FA_QT)
    return -1;
  const size_t smem = qv_flash_smem(a, is_bf16);
  if (!is_bf16)
    return qv_launch(qv::flash_kernel<float>, *a, smem, stream,
                     a->B * a->H * a->q_tiles);
  // bf16: the instance whose register arrays cover nkv and d
  const int nk16 = (a->nkv + 15) / 16, kd = (a->d + 15) / 16;
  const int grid = a->B * a->H *
                   ((a->nq + qv::FA_MMA_QT - 1) / qv::FA_MMA_QT);
  if (kd <= 3) {
    if (nk16 <= 3)
      return qv_launch(qv::flash_mma_kernel<3, 3>, *a, smem, stream, grid);
    if (nk16 <= 6)
      return qv_launch(qv::flash_mma_kernel<6, 3>, *a, smem, stream, grid);
    return qv_launch(qv::flash_mma_kernel<9, 3>, *a, smem, stream, grid);
  }
  if (nk16 <= 3)
    return qv_launch(qv::flash_mma_kernel<3, 4>, *a, smem, stream, grid);
  if (nk16 <= 6)
    return qv_launch(qv::flash_mma_kernel<6, 4>, *a, smem, stream, grid);
  return qv_launch(qv::flash_mma_kernel<9, 4>, *a, smem, stream, grid);
}

// Bytes of dynamic shared memory a launch with `a` asks for.
extern "C" int qv_flash_smem(const qv::FlashArgs* a, int is_bf16) {
  return is_bf16 ? qv::flash_mma_smem_bytes(*a)
                 : qv::flash_smem_floats(*a) * (int)sizeof(float);
}

extern "C" int qv_flash_struct_size() { return (int)sizeof(qv::FlashArgs); }
