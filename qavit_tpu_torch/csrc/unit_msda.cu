// Unit 2 of the fused block, forward (eval and train): the MSDA branch.
//
// Replaces the TPU unit qavit_tpu/kernels/fused_kernels.py
// make_cores.core_msda (fused_cores.py:687 msda_bd), run through
// fused_pallas.py:190-212 fwd_call.
//
// Per sample: the dilated (1,2) gather and stride-2 landmark pooling are
// one constant [keep, n] mixing matrix; kv = pooled @ W[:, 192:576]; the
// Linformer E uses only its first msda_keep rows (the rest meet the
// zero padding); the 16 raw bank rows are appended (kv = 48);
// q = xn @ W[:, :192]; 4-head softmax attention; proj 192 -> 192.  In
// training: the hash masks and the bank-write partials, as in unit 1.
//
// n = 16 (hqavit_c100), msda_kernel: bound on the H100 at B=1024 (bf16):
// 6.3 MB read + 6.3 MB written (~3.8 us) and ~3.5 GFLOP (~3.5 us): either
// limit allows a few microseconds.  The design is the SWA unit's: 256
// threads hold one sample at a time, all intermediates in ~160 KB of
// shared memory, float32 FMAs; it is latency-bound.  It runs float32, and
// bf16 at widths the tensor-core kernel is not written for; bf16 at
// hqavit_c100's widths runs msda_mma16_kernel (below), eval and training.
//
// n = 64 (hqavit_tiny_in / hqavit_proc_tin, eval), 64 queries, 40 pooled
// rows.  Bound on the H100 at B=1024 (bf16): 51 MB of xn, out and the
// float32 weights (~15 us at 3.35 TB/s) against 19.2 GFLOP (~19.4 us at
// 989 TFLOP/s): the operations bound it, most of them the kv, q and proj
// products, so the bf16 kernel runs every product on the tensor cores.
//
// float32, msda_tiled_kernel (CUDA cores; TF32 keeps too few digits for
// the 1e-4 tolerance): xn, the compressed K/V (32 + 16 rows per head) and
// the bank stay in shared memory; the pooled rows and their kv are built
// once per sample, then q, scores, PV and proj run over 16-query tiles in
// the space the pooled rows held (215 KB at C=192), every element summed
// in the order of the n = 16 kernel.
//
// bf16, msda_mma_kernel: every product on the tensor cores (mma.sync
// m16n8k16, bf16 operands, float32 sums; mma.cuh), every intermediate
// that the plain version rounds to bf16 held as bf16 in shared memory
// (177 KB).  One block per SM walks the samples; while one sample's
// attention and proj run, cp.async brings the next one's xn.  Per sample:
// the pooling as a gather (each pooled row sums its sel_t non-zeros in
// token order, as token_mix does, so it is bit-identical); kv = pooled @
// W_kv + b (48 padded rows x 384 x 192) with W_kv streamed in 32-row
// slices through a two-buffer cp.async ring; kc | vc = E^T @ k | v (32 x
// 192 x 48, E^T zero-padded past msda_keep); then each warp takes 16
// queries x 2 heads: q = xn @ W_q + b through the ring, rounded straight
// into A fragments, the 48 scores of each head in registers (divided by
// sqrt(D) as common.cuh's attention does), float32 softmax by quad
// shuffles, rnd(P) V, and the attention rows to shared memory; proj =
// att @ W_p + b through the ring, stored from registers.  The weights
// reach the kernel as bf16: the wrapper casts W_qkv and W_proj once per
// call (rnd<bf16> of a float32 weight is its bf16 cast), so cp.async can
// copy them.  The batch-wide NaN guard is kept: q, kc, vc, the bank and
// the attention output are checked, and the redo writes proj(0) to every
// sample.  Time at B=1024 on an NVIDIA H100 80GB HBM3, 700.00 W
// (chip_smoke.py phase l, PERF.md section 6 row 2 @n64): 0.281-0.286 ms
// per launch, 15x its bound, against 7.60-7.62 ms for the CUDA-core
// tiled kernel in the same runs and 2.53-2.60 ms for the plain version.
// n = 64 in training is msda_train64_kernel's (unit_msda_train64.cu).
#include "unit_msda.cuh"
#include "window_mma.cuh"

namespace qv {

__host__ __device__ inline int msda_smem_floats(const Dims& d) {
  const int c = d.c;
  return NT * c             // xs
         + NT * c           // pooled, then the proj output
         + NT * 2 * c       // kv of the pooled rows
         + 2 * d.lin_k * c  // compressed k, v
         + 2 * d.bank_s * c // bank k, v
         + NT * c           // q, then the partials' compressed rows
         + NT * c           // attention output, then LN(out)
         + pad4(d.heads * NT * (d.lin_k + d.bank_s))
         + 2 * NT;          // LN stats
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS, 1) msda_kernel(MsdaArgs a) {
  QV_SMEM_DECL
  __shared__ int bad;
  const Dims& d = a.d;
  const int c = d.c, lk = d.lin_k, S = d.bank_s;
  float* xs = qv_smem;
  float* pooled = xs + NT * c;
  float* kv = pooled + NT * c;
  float* kc = kv + NT * 2 * c;
  float* vc = kc + lk * c;
  float* bk = vc + lk * c;
  float* bv = bk + S * c;
  float* q = bv + S * c;
  float* att = q + NT * c;
  float* sc = att + NT * c;
  float* stats = sc + pad4(d.heads * NT * (lk + S));
  const MsdaBufs s{xs, pooled, kv, kc, vc, bk, bv, q, att, pooled, sc, sc};
  float* part = d.train ? a.bw.part + (size_t)blockIdx.x * 2 * S * c : nullptr;

  if (threadIdx.x == 0) bad = 0;
  load_rounded<T>(bk, a.bank_k, S * c);
  load_rounded<T>(bv, a.bank_v, S * c);
  if (part != nullptr) fill(part, 2 * S * c, 0.f);
  __syncthreads();
  auto sample = [&](int b, bool zero_attn, float* acc) {
    msda_body<T>(a, b, zero_attn, s, &bad);
    store_tile<T>(static_cast<T*>(a.out) + (size_t)b * NT * c, pooled,
                  NT * c);
    __syncthreads();
    if (acc != nullptr)
      bank_partials<T>(pooled, a.bw, c, S, att, q, sc, stats, acc);
  };
  for (int b = blockIdx.x; b < d.B; b += gridDim.x) sample(b, false, part);
  if (d.guard)
    finish_guard(a.ws, bad, [&] {
      if (part != nullptr) {
        fill(a.bw.part, d.grid * 2 * S * c, 0.f);
        __syncthreads();
      }
      for (int b = 0; b < d.B; ++b) sample(b, true, part);
    });
}

__host__ __device__ inline int msda_tiled_smem_floats(const Dims& d) {
  const int c = d.c, kv = d.lin_k + d.bank_s;
  const int pool = 3 * d.msda_keep * c;                 // pooled, its k|v
  const int tile = 2 * NT * c + pad4(d.heads * NT * kv);  // q / o, att, sc
  return d.n * c              // xn
         + 2 * d.lin_k * c    // compressed k, v
         + 2 * d.bank_s * c   // bank k, v
         + (pool > tile ? pool : tile);
}

// Eval only, n a multiple of NT; one block per sample.
template <typename T>
__global__ void __launch_bounds__(NTHREADS, 1)
    msda_tiled_kernel(MsdaArgs a) {
  QV_SMEM_DECL
  __shared__ int bad;
  const Dims& d = a.d;
  const int c = d.c, lk = d.lin_k, S = d.bank_s, h = d.heads;
  const int n = d.n, keep = d.msda_keep;
  float* xs = qv_smem;
  float* kc = xs + n * c;
  float* vc = kc + lk * c;
  float* bk = vc + lk * c;
  float* bv = bk + S * c;
  float* pooled = bv + S * c;     // [keep, c], then the query tiles:
  float* kvp = pooled + keep * c;  // [keep, 2c]
  float* q = pooled;              // [NT, c] q, then the proj output
  float* att = q + NT * c;        // [NT, c]
  float* sc = att + NT * c;       // [heads, NT, lin_k + S]

  if (threadIdx.x == 0) bad = 0;
  load_rounded<T>(bk, a.bank_k, S * c);
  load_rounded<T>(bv, a.bank_v, S * c);
  __syncthreads();
  auto sample = [&](int b, bool zero_attn) {
    const size_t off = (size_t)b * n * c;
    load_tile<T>(xs, static_cast<const T*>(a.xn) + off, n * c);
    __syncthreads();
    token_mix<T>(a.sel_t, keep, n, xs, c, c, pooled, c);
    __syncthreads();
    for (int r0 = 0; r0 < keep; r0 += NT)
      dense_rows<T>(pooled + r0 * c, c, 0, keep - r0 < NT ? keep - r0 : NT, c,
                    a.qkv_w + c, 3 * c, a.qkv_b + c, 2 * c, 1,
                    kvp + r0 * 2 * c, 2 * c);
    __syncthreads();
    token_mix<T>(a.e_k, lk, keep, kvp, 2 * c, c, kc, c);
    token_mix<T>(a.e_v, lk, keep, kvp + c, 2 * c, c, vc, c);
    __syncthreads();
    for (int t0 = 0; t0 < n; t0 += NT) {
      dense_rows<T>(xs + t0 * c, c, 0, NT, c, a.qkv_w, 3 * c, a.qkv_b, c, 1,
                    q, c);
      __syncthreads();
      if (zero_attn) {
        fill(att, NT * c, 0.f);
        __syncthreads();
      } else {
        attention<T>(q, c, NT, h, c / h, kc, vc, c, lk, bk, bv, c, S, h, att,
                     c, sc, sc, no_drop(), 0u, &bad, d.guard != 0);
      }
      dense_rows<T>(att, c, 0, NT, c, a.proj_w, c, a.proj_b, c, 1, q, c);
      __syncthreads();
      store_tile<T>(static_cast<T*>(a.out) + off + (size_t)t0 * c, q,
                    NT * c);
      __syncthreads();
    }
  };
  for (int b = blockIdx.x; b < d.B; b += gridDim.x) sample(b, false);
  if (d.guard)
    finish_guard(a.ws, bad, [&] {
      for (int b = 0; b < d.B; ++b) sample(b, true);
    });
}

// --- n = 64, bf16: the tensor-core kernel -----------------------------------

// the geometry msda_mma_kernel is written for (fused_kernels.msda_mma_error)
constexpr int MM_N = 64, MM_C = 192, MM_H = 4, MM_D = MM_C / MM_H;
static_assert(MM_D == ATT_D, "warp_attention's head width");
constexpr int MM_LK = 32;               // compressed keys
constexpr int MM_S = 16;                // bank rows, at most
constexpr int MM_KEEP = 48;             // pooled rows, padded to 3 m16 tiles
constexpr int MM_POOL = 8;              // terms of a pooled row, at most
// leading dims: 8 bf16 past the width, so that the 8 rows one ldmatrix
// reads start in distinct banks
constexpr int MM_LDX = MM_C + 8, MM_LDKV = 2 * MM_C + 8;
constexpr int MM_LDE = MM_KEEP + 8;
// shared memory, in bf16 elements, then the pooling lists (4-byte words)
constexpr int MM_BANK = 2 * MM_S * MM_LDX;         // bank k, v
constexpr int MM_ET = 2 * MM_LK * MM_LDE;          // E_k^T, E_v^T
constexpr int MM_XS = MM_N * MM_LDX;               // xn
constexpr int MM_REGION = MM_KEEP * (MM_LDX + MM_LDKV);  // pooled + kv;
                                                   // then the attention rows
constexpr int MM_KCVC = 2 * MM_LK * MM_LDX;        // kc, vc
constexpr int MM_RING = 2 * RING_KS * MM_LDKV;     // weight slices
constexpr int MM_BF16 = MM_BANK + MM_ET + MM_XS + MM_REGION + MM_KCVC +
                        MM_RING;
constexpr int MM_SMEM_BYTES =
    MM_BF16 * 2 + MM_KEEP * (1 + 2 * MM_POOL) * 4;

// Eval only: n = 64 in training is msda_train64_kernel's, on two-CTA
// clusters (unit_msda_train64.cu).
__global__ void __launch_bounds__(NTHREADS, 1)
    msda_mma_kernel(MsdaMmaArgs m) {
  QV_SMEM_DECL
  __shared__ int bad;
  const MsdaArgs& a = m.f;
  const Dims& d = a.d;
  const int S = d.bank_s, keep = d.msda_keep, C = MM_C;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  bf16* bk = reinterpret_cast<bf16*>(qv_smem);
  bf16* bv = bk + MM_S * MM_LDX;
  bf16* et = bv + MM_S * MM_LDX;           // [2][MM_LK][MM_LDE]
  bf16* xs = et + MM_ET;
  bf16* pooled = xs + MM_XS;               // [MM_KEEP][MM_LDX]
  bf16* kvp = pooled + MM_KEEP * MM_LDX;   // [MM_KEEP][MM_LDKV]
  bf16* att = pooled;                      // [MM_N][MM_LDX], after kc | vc
  bf16* kc = pooled + MM_REGION;
  bf16* vc = kc + MM_LK * MM_LDX;
  bf16* ring = vc + MM_LK * MM_LDX;
  int* pool_n = reinterpret_cast<int*>(ring + MM_RING);
  int* pool_src = pool_n + MM_KEEP;        // [MM_KEEP][MM_POOL]
  float* pool_w = reinterpret_cast<float*>(pool_src + MM_KEEP * MM_POOL);
  const bf16 zero = from_f<bf16>(0.f);

  if (threadIdx.x == 0) bad = 0;
  __syncthreads();
  // per block: the bank rows rounded (rows past S zero), E_k^T and E_v^T
  // rounded (columns past msda_keep zero), and the pooling's non-zeros
  // read off sel_t [n, keep], staged through the ring
  float* sel = reinterpret_cast<float*>(ring);
  for (int i = threadIdx.x; i < MM_N * keep; i += blockDim.x)
    sel[i] = a.sel_t[i];
  for (int i = threadIdx.x; i < MM_S * C; i += blockDim.x) {
    const int r = i / C, c = i - r * C;
    const float vk = r < S ? rnd<bf16>(a.bank_k[r * C + c]) : 0.f;
    const float vv = r < S ? rnd<bf16>(a.bank_v[r * C + c]) : 0.f;
    if (d.guard && (isnan(vk) || isnan(vv))) bad = 1;
    bk[r * MM_LDX + c] = from_f<bf16>(vk);
    bv[r * MM_LDX + c] = from_f<bf16>(vv);
  }
  for (int i = threadIdx.x; i < 2 * MM_LK * MM_KEEP; i += blockDim.x) {
    const int w = i / (MM_LK * MM_KEEP), r = i - w * MM_LK * MM_KEEP;
    const int mrow = r / MM_KEEP, k = r - mrow * MM_KEEP;
    const float* e = w ? a.e_v : a.e_k;
    et[w * MM_LK * MM_LDE + mrow * MM_LDE + k] =
        k < keep ? from_f<bf16>(rnd<bf16>(e[k * MM_LK + mrow])) : zero;
  }
  __syncthreads();
  if (threadIdx.x < keep) {
    const int r = threadIdx.x;
    int cnt = 0;
    for (int n = 0; n < MM_N; ++n) {
      const float w = sel[n * keep + r];
      if (w != 0.f && cnt < MM_POOL) {
        pool_src[r * MM_POOL + cnt] = n;
        pool_w[r * MM_POOL + cnt] = rnd<bf16>(w);
        ++cnt;
      }
    }
    pool_n[r] = cnt;
  }

  auto stage_xn = [&](int b) {
    const bf16* src = static_cast<const bf16*>(a.xn) + (size_t)b * MM_N * C;
    for (int i = threadIdx.x; i < MM_N * (C / 8); i += blockDim.x) {
      const int r = i / (C / 8), c = (i - r * (C / 8)) * 8;
      cp_async_16(xs + r * MM_LDX + c, src + r * C + c);
    }
    cp_async_commit();
  };
  // the warp's queries and heads in q, attention and proj
  const int mt = warp >> 1, half = warp & 1;
  const int qcol = half * (C / 2);         // first of the warp's 96 columns

  if (blockIdx.x < d.B) stage_xn(blockIdx.x);
  for (int b = blockIdx.x; b < d.B; b += gridDim.x) {
    cp_async_wait<0>();
    __syncthreads();
    // pooled rows: each the sum of its non-zeros in token order
    for (int i = threadIdx.x; i < MM_KEEP * C; i += blockDim.x) {
      const int r = i / C, c = i - r * C;
      float acc = 0.f;
      if (r < keep)
        for (int p = 0; p < pool_n[r]; ++p)
          acc = fmaf(pool_w[r * MM_POOL + p],
                     to_f<bf16>(xs[pool_src[r * MM_POOL + p] * MM_LDX + c]),
                     acc);
      pooled[r * MM_LDX + c] = from_f<bf16>(acc);
    }
    __syncthreads();
    {  // kv = pooled @ W_kv + b: warp w, columns 48w.. of 384, all rows
      float acc[3][6][4];
      ring_gemm<3, 6>(pooled, MM_LDX, m.qkv_w16 + C, 3 * C, 2 * C, C, ring,
                      MM_LDKV, 48 * warp, acc);
#pragma unroll
      for (int mi = 0; mi < 3; ++mi)
#pragma unroll
        for (int j = 0; j < 6; ++j) {
          const int col = 48 * warp + 8 * j + 2 * t;
          const float b0 = a.qkv_b[C + col], b1 = a.qkv_b[C + col + 1];
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
            store_bf16x2(kvp + (mi * 16 + g + 8 * hf) * MM_LDKV + col,
                         pack_bf16x2(dense_out(acc[mi][j][2 * hf], b0),
                                     dense_out(acc[mi][j][2 * hf + 1], b1)));
        }
    }
    __syncthreads();
    {  // kc | vc = rnd(E^T @ k | v): warps 0-3 k, 4-7 v, 48 columns each
      const int w = warp >> 2, c0 = 48 * (warp & 3);
      const bf16* ew = et + w * MM_LK * MM_LDE;
      float acc[2][6][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < 6; ++j)
          acc[mi][j][0] = acc[mi][j][1] = acc[mi][j][2] = acc[mi][j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < MM_KEEP / 16; ++kk) {
        unsigned af[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          load_a(af[mi], ew + mi * 16 * MM_LDE + kk * 16, MM_LDE, lane);
#pragma unroll
        for (int np = 0; np < 3; ++np) {
          unsigned kb[4];
          load_b_kn(kb, kvp + kk * 16 * MM_LDKV + w * C + c0 + np * 16,
                    MM_LDKV, lane);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            mma_bf16_16816(acc[mi][2 * np], af[mi], kb);
            mma_bf16_16816(acc[mi][2 * np + 1], af[mi], kb + 2);
          }
        }
      }
      bf16* dst = w ? vc : kc;
      bool nan_seen = false;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < 6; ++j)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const float x0 = acc[mi][j][2 * hf], x1 = acc[mi][j][2 * hf + 1];
            nan_seen = nan_seen || isnan(x0) || isnan(x1);
            store_bf16x2(dst + (mi * 16 + g + 8 * hf) * MM_LDX + c0 + 8 * j +
                             2 * t,
                         pack_bf16x2(x0, x1));
          }
      if (d.guard && nan_seen) bad = 1;
    }
    __syncthreads();
    // q = xn @ W_q + b: warp (mt, half) rows 16 mt.., columns qcol..
    unsigned qa[2][3][4];            // [head][16-column step] A fragments
    {
      float acc[1][12][4];
      ring_gemm<1, 12>(xs + mt * 16 * MM_LDX, MM_LDX, m.qkv_w16, 3 * C, C, C,
                       ring, MM_LDX, qcol, acc);
      if (q_fragments(acc, a.qkv_b, qcol, qa) && d.guard) bad = 1;
    }
    // xs is free: bring the next sample's xn while this one finishes
    if (b + (int)gridDim.x < d.B) stage_xn(b + gridDim.x);
    {  // attention of the warp's 16 queries, heads 2 half and 2 half + 1,
       // over 32 compressed keys and MM_S bank keys (past 32 + S: -inf)
      const bf16* const kt[3] = {kc, kc + 16 * MM_LDX, bk};
      const bf16* const vt[3] = {vc, vc + 16 * MM_LDX, bv};
      bool nan_seen = false;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int vh = 2 * half + hh;
        nan_seen |= warp_attention<3>(qa[hh], kt, vt, MM_LDX, vh * MM_D,
                                      MM_LK + S, att + mt * 16 * MM_LDX,
                                      MM_LDX);
      }
      if (d.guard && nan_seen) bad = 1;
    }
    __syncthreads();
    {  // proj = att @ W_p + b, stored from the fragments (ring_gemm's
       // last barrier: every warp's reads of att are done)
      float acc[1][12][4];
      ring_gemm<1, 12>(att + mt * 16 * MM_LDX, MM_LDX, m.proj_w16, C, C, C,
                       ring, MM_LDX, qcol, acc);
      bf16* out = static_cast<bf16*>(a.out) + ((size_t)b * MM_N + mt * 16) * C;
#pragma unroll
      for (int j = 0; j < 12; ++j) {
        const int col = qcol + 8 * j + 2 * t;
        const float b0 = a.proj_b[col], b1 = a.proj_b[col + 1];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          store_bf16x2(out + (g + 8 * hf) * C + col,
                       pack_bf16x2(dense_out(acc[0][j][2 * hf], b0),
                                   dense_out(acc[0][j][2 * hf + 1], b1)));
      }
    }
  }
  if (d.guard)
    finish_guard(a.ws, bad, [&] {
      // the redo: a zero attention output, so every sample's rows are
      // proj(0), computed once
      for (int i = threadIdx.x; i < MM_N * MM_LDX; i += blockDim.x)
        att[i] = zero;
      __syncthreads();
      float acc[1][12][4];
      ring_gemm<1, 12>(att + mt * 16 * MM_LDX, MM_LDX, m.proj_w16, C, C, C,
                       ring, MM_LDX, qcol, acc);
      for (int b = 0; b < d.B; ++b) {
        bf16* out =
            static_cast<bf16*>(a.out) + ((size_t)b * MM_N + mt * 16) * C;
#pragma unroll
        for (int j = 0; j < 12; ++j) {
          const int col = qcol + 8 * j + 2 * t;
          const float b0 = a.proj_b[col], b1 = a.proj_b[col + 1];
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
            store_bf16x2(out + (g + 8 * hf) * C + col,
                         pack_bf16x2(dense_out(acc[0][j][2 * hf], b0),
                                     dense_out(acc[0][j][2 * hf + 1], b1)));
        }
      }
    });
}

// --- n = 16, bf16: the tensor-core kernel ----------------------------------

// hqavit_c100's MSDA at n = 16, eval and training (TRAIN): four samples
// to a tile of 64 rows in SWA's layout (window_mma.cuh), each sample's
// 10 pooled rows from row 16 s.  The n = 64 layout keeps one kc | vc
// pair in 177 KB; four pairs, one a sample, would take ~77 KB more, past
// the 227 KB a block may hold, while SWA's layout has room for them
// (195 KB with the pooling lists): kv runs over 64 rows (the pooled rows
// padded to 16 a sample) instead of 40, but every window's Linformer
// product reads its own sample's rows alone, and the products keep the
// n = 64 kernels' shapes.  (Passes of two samples would halve the work
// between barriers, which is what bounds these kernels.)
template <bool TRAIN>
__global__ void __launch_bounds__(NTHREADS, 1)
    msda_mma16_kernel(MsdaMmaArgs m) {
  window_mma<WIN_MSDA, 4, TRAIN>(m);
}

}  // namespace qv

extern "C" int qv_unit_msda_smem(const qv::Dims* d);

extern "C" int qv_unit_msda(const qv::MsdaArgs* a, int is_bf16,
                            void* stream) {
  const size_t smem = qv_unit_msda_smem(&a->d);
  if (a->d.n != qv::NT) {         // eval only; bf16 is qv_unit_msda_mma's
    if (a->d.train || is_bf16) return qv::ERR_ARGS;
    return qv_launch(qv::msda_tiled_kernel<float>, *a, smem, stream,
                     a->d.grid);
  }
  const int rc =
      is_bf16 ? qv_launch(qv::msda_kernel<qv::bf16>, *a, smem, stream,
                          a->d.grid)
              : qv_launch(qv::msda_kernel<float>, *a, smem, stream, a->d.grid);
  if (rc != 0 || !a->d.train) return rc;
  return qv_reduce(a->bw.part, a->bw.part_out, a->d.grid,
                   2 * a->d.bank_s * a->d.c, a->d.rgrid, stream);
}

extern "C" int qv_unit_msda_smem(const qv::Dims* d) {
  return (d->n == qv::NT ? qv::msda_smem_floats(*d)
                         : qv::msda_tiled_smem_floats(*d)) *
         (int)sizeof(float);
}

// The bf16 tensor-core kernels: `a` as for qv_unit_msda, the qkv and proj
// kernels rounded to bf16 beside it; one block per tile of 64 rows at
// most.  n = 64 in eval (msda_mma_kernel), or n = 16 in eval and training
// (msda_mma16_kernel; then the reduction pass of the bank partials
// follows); ERR_ARGS for any other geometry or type (the wrapper checks
// them first, msda_mma_error).
extern "C" int qv_unit_msda_mma(const qv::MsdaArgs* a, const void* qkv_w16,
                                const void* proj_w16, int is_bf16,
                                void* stream) {
  const qv::Dims& d = a->d;
  const bool n64 = d.n == qv::MM_N && !d.train &&
                   d.msda_keep <= qv::MM_KEEP;
  const bool n16 = d.n == qv::NT && d.nw == 1 && d.msda_keep <= qv::NT;
  const int tiles = (d.B * d.n + qv::SM_N - 1) / qv::SM_N;
  if (!is_bf16 || !(n64 || n16) || d.c != qv::MM_C || d.heads != qv::MM_H ||
      d.lin_k != qv::MM_LK || d.bank_s > qv::MM_S || d.grid > tiles)
    return qv::ERR_ARGS;
  const qv::MsdaMmaArgs m{*a, static_cast<const qv::bf16*>(qkv_w16),
                          static_cast<const qv::bf16*>(proj_w16)};
  if (n64)
    return qv_launch(qv::msda_mma_kernel, m, qv::MM_SMEM_BYTES, stream,
                     d.grid);
  const int rc = d.train ? qv_launch(qv::msda_mma16_kernel<true>, m,
                                     qv::SM_MSDA_BYTES, stream, d.grid)
                         : qv_launch(qv::msda_mma16_kernel<false>, m,
                                     qv::SM_MSDA_BYTES, stream, d.grid);
  if (rc != 0 || !d.train) return rc;
  return qv_reduce(a->bw.part, a->bw.part_out, d.grid, 2 * d.bank_s * d.c,
                   d.rgrid, stream);
}

// the shared memory of the launch with dims d (without d: of the n = 64
// kernel)
extern "C" int qv_unit_msda_mma_smem(const qv::Dims* d) {
  return d != nullptr && d->n == qv::NT ? qv::SM_MSDA_BYTES
                                        : qv::MM_SMEM_BYTES;
}
