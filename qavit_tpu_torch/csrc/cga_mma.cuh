// The bf16 tensor-core CGA unit: the forward body of cga_mma_kernel
// (unit_cga.cu) and the pieces cga_bwd_mma_kernel (unit_cga_bwd.cu)
// recomputes the unit with.
//
// Geometry (fused_kernels.cga_mma_error): C = 192 in 6 channel groups of
// 32; q, k, v each a Dense 32 -> 16 whose kernel the groups share; the
// bank's K and V rows (at most 16) projected 192 -> 16 once a block and
// shared by the groups; 24 virtual heads (6 groups x 4 heads) of width 4
// over a sample's own n keys and the bank's; proj 96 -> 192.  A tile is 64
// token rows: four samples of n = 16 (NS = 4, a short last tile loads and
// stores only its own samples' rows) or one sample of n = 64 (NS = 1).
//   q | k | v  one product of the tile's 64 x 6 group rows (32 wide) by
//              the packed [32, 48] kernel, dense epilogue per column
//   attention  a warp per (16-query tile, group): its q rows are one A
//              fragment of the group's 16 channels.  A head is 4 wide,
//              under mma.sync's k = 16, so each head's scores are the
//              product over all 16 channels with the other three heads'
//              channels zeroed in both operands (by selects, so that an
//              inf or NaN of another head stays out); float32 softmax in
//              registers; P rounded to bf16 straight into A fragments
//              (after the dropout in training) times V, whose output
//              columns are each computed from their own V column alone,
//              so the lanes holding head h's four columns keep them
//   proj       att [64, 96] @ W_p [96, 192] from shared memory: K = 96 is
//              three ring slices, so the weight stays resident, loaded
//              once a block by cp.async
// Rounding follows fused_ref.cga_ref: q, k, v, the projected bank, the
// attention output and proj rounded to bf16 where dense and
// attention_core round, every product summed in float32 (mma.sync
// m16n8k16, bf16 operands).  The batch-wide NaN guard checks q, k, v, the
// projected bank and the attention output; the last block redoes the
// batch with a zero attention output, every row proj(0).  Training (a
// compile-time instance at either geometry) replays the CGA_ATTN and
// CGA_PROJ masks at each element's flat index in its own sample, as
// cga_body indexes them, and keeps the bank-write partials (mma_ops.cuh
// bank_tile_partials, the gate's softmax over the sample's n tokens) per
// thread over the block's tiles.  The n = 64 training instance, a sample
// a block at B=128, does once a block what the others amortise over
// their tiles, so it projects the bank on the tensor cores
// (cga_bank_proj_mma), scales both dropouts' kept values by the product
// with 1 / keep (an IEEE division an element was 56-68% of its time,
// PERF.md section 6) and leaves part_k to a pass after the blocks' sum
// (bank_store_sums, qv_bank_compress).
#pragma once
#include "mma_ops.cuh"

// The forward body's phase stamps: QV_STAMP of unit_cga.cu's array where
// that file defines CGA_FWD_STAMP (built with -DQV_STAMPS), else nothing
#ifndef CGA_FWD_STAMP
#define CGA_FWD_STAMP(k)
#endif

namespace qv {

struct CgaMmaArgs {
  CgaArgs f;              // the unit's arguments (the q/k/v and proj
                          // kernels unread)
  const bf16* qkv_w16;    // [32, 48] q | k | v kernels rounded to bf16
  const bf16* proj_w16;   // [96, 192]
};

// the geometry the kernels are written for (fused_kernels.cga_mma_error,
// cga_bwd_mma_error)
constexpr int CG_C = 192, CG_G = 6, CG_CPG = 32, CG_CPERG = 16, CG_H = 4;
constexpr int CG_HD = CG_CPERG / CG_H;      // a head's width
constexpr int CG_GW = CG_G * CG_CPERG;      // 96: q, k, v, att widths
constexpr int CG_QKV = 3 * CG_CPERG;        // 48: the packed kernel's
constexpr int CG_S = 16;                    // bank rows, at most
constexpr int CG_ROWS = 64;                 // rows of a tile
static_assert(CG_C == BP_C && CG_S == BP_S && CG_ROWS == BP_ROWS,
              "the bank partials' widths");
// leading dims: 8 bf16 past the width, so that the 8 rows one ldmatrix
// reads start in distinct banks
constexpr int CG_LDX = CG_C + 8, CG_LDQ = CG_GW + 8;
constexpr int CG_LDW = CG_QKV + 8, CG_LDB = CG_CPERG + 8;
// shared memory, in bf16 elements
constexpr int CG_W_QKV = CG_CPG * CG_LDW;          // q | k | v kernel
constexpr int CG_W_PROJ = CG_GW * CG_LDX;          // proj kernel
constexpr int CG_BANK = 2 * CG_S * CG_LDB;         // projected bank k, v
constexpr int CG_XS = CG_ROWS * CG_LDX;            // [64, C] rows
constexpr int CG_QB = CG_ROWS * CG_LDQ;            // [64, 96] rows
constexpr int CG_EVAL_BYTES =
    2 * (CG_W_QKV + CG_W_PROJ + CG_BANK + 2 * CG_XS + 4 * CG_QB);
constexpr int CG_TRAIN_BYTES = CG_EVAL_BYTES + 4 * BP_SCRATCH;

// rows x cols bf16 (cols a multiple of 8) from device memory (leading dim
// cols) into shared memory (leading dim ld) by cp.async; the caller
// commits.  Block-wide.
__device__ __forceinline__ void stage_weight(bf16* dst, int ld,
                                             const bf16* src, int rows,
                                             int cols) {
  const int cpr = cols / 8;
  for (int i = threadIdx.x; i < rows * cpr; i += NTHREADS) {
    const int r = i / cpr, c = (i - r * cpr) * 8;
    cp_async_16(dst + r * ld + c, src + (size_t)r * cols + c);
  }
}

// The projected bank rows kbp, vbp [16, 16] (leading dim CG_LDB; rows past
// S zero) = dense(rnd(bank)) in float32 FMAs, as cga_prologue; true if
// one is NaN.  Block-wide, without a barrier.
__device__ __forceinline__ bool cga_bank_proj(const CgaArgs& a, bf16* kbp,
                                              bf16* vbp) {
  const int S = a.d.bank_s;
  bool nan_seen = false;
  for (int i = threadIdx.x; i < 2 * CG_S * CG_CPERG; i += NTHREADS) {
    const int w = i / (CG_S * CG_CPERG), m = (i / CG_CPERG) % CG_S;
    const int j = i % CG_CPERG;
    float v = 0.f;
    if (m < S) {
      const float* x = (w ? a.bank_v : a.bank_k) + m * CG_C;
      const float* W = w ? a.bv_w : a.bk_w;
      float acc = 0.f;
#pragma unroll 16           // 16 loads in flight: the rows come from L2
      for (int k = 0; k < CG_C; ++k)
        acc = fmaf(rnd<bf16>(x[k]), rnd<bf16>(W[k * CG_CPERG + j]), acc);
      v = dense_out(acc, (w ? a.bv_b : a.bk_b)[j]);
      nan_seen = nan_seen || isnan(v);
    }
    (w ? vbp : kbp)[m * CG_LDB + j] = from_f<bf16>(v);
  }
  return nan_seen;
}

// cga_bank_proj's kbp, vbp on the tensor cores: the bank rows and the two
// kernels rounded to bf16 into `stage` (CG_BSTAGE elements of shared
// memory, 16-byte aligned), then warp 0 the 16 k rows and warp 1 the 16 v
// rows, [16, 192] @ [192, 16] in mma.sync (bf16 operands, float32 sums,
// the rounding points of cga_bank_proj's FMAs), dense_out; rows past S
// zero.  True if one is NaN.  Block-wide: one barrier, none at the end.
constexpr int CG_LDBW = CG_CPERG + 8;       // a staged kernel's leading dim
constexpr int CG_BSTAGE = 2 * CG_S * CG_LDX + 2 * CG_C * CG_LDBW;
__device__ __forceinline__ bool cga_bank_proj_mma(const CgaArgs& a,
                                                  bf16* kbp, bf16* vbp,
                                                  bf16* stage) {
  const int S = a.d.bank_s;
  bf16* rows = stage;                        // [32][CG_LDX]: k, then v
  bf16* wt = stage + 2 * CG_S * CG_LDX;      // [2][C][CG_LDBW]
  // a fixed count a thread, unrolled: its loads from L2 in flight at once
#pragma unroll
  for (int i = threadIdx.x; i < 2 * CG_S * CG_C; i += NTHREADS) {
    const int r = i / CG_C, c = i - r * CG_C, m = r % CG_S;
    const float* x = r < CG_S ? a.bank_k : a.bank_v;
    rows[r * CG_LDX + c] = from_f<bf16>(m < S ? rnd<bf16>(x[m * CG_C + c])
                                              : 0.f);
  }
#pragma unroll
  for (int i = threadIdx.x; i < 2 * CG_C * CG_CPERG; i += NTHREADS) {
    const int w = i / (CG_C * CG_CPERG), e = i - w * CG_C * CG_CPERG;
    const int k = e / CG_CPERG, j = e - k * CG_CPERG;
    wt[(w * CG_C + k) * CG_LDBW + j] =
        from_f<bf16>(rnd<bf16>((w ? a.bv_w : a.bk_w)[e]));
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= 2) return false;
  const int g = lane >> 2, t = lane & 3;
  const bf16* A = rows + warp * CG_S * CG_LDX;
  const bf16* W = wt + warp * CG_C * CG_LDBW;
  float acc[2][4] = {};
#pragma unroll
  for (int ks = 0; ks < CG_C / 16; ++ks) {
    unsigned af[4], bf[4];
    load_a(af, A + 16 * ks, CG_LDX, lane);
    load_b_kn(bf, W + 16 * ks * CG_LDBW, CG_LDBW, lane);
    mma_bf16_16816(acc[0], af, bf);
    mma_bf16_16816(acc[1], af, bf + 2);
  }
  const float* bias = warp ? a.bv_b : a.bk_b;
  bf16* dst = warp ? vbp : kbp;
  bool nan_seen = false;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int m = g + 8 * hf, c = 8 * j + 2 * t;
      float v0 = 0.f, v1 = 0.f;
      if (m < S) {
        v0 = dense_out(acc[j][2 * hf], bias[c]);
        v1 = dense_out(acc[j][2 * hf + 1], bias[c + 1]);
        nan_seen = nan_seen || isnan(v0) || isnan(v1);
      }
      store_bf16x2(dst + m * CG_LDB + c, pack_bf16x2(v0, v1));
    }
  return nan_seen;
}

// q | k | v [64, 96] each (leading dim CG_LDQ; group g at columns 16 g..)
// of the 64 rows xs (leading dim CG_LDX) through the packed kernel wqkv
// ([32, 48] in shared memory, leading dim CG_LDW), with the dense
// epilogue: warp w the units (16-row tile, group) w, w + 8, w + 16.  True
// if one is NaN.  Block-wide, without a barrier.
__device__ __forceinline__ bool cga_qkv(const bf16* xs, const bf16* wqkv,
                                        const CgaArgs& a, bf16* q, bf16* k,
                                        bf16* v) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  bf16* const dst[3] = {q, k, v};
  const float* const bias[3] = {a.q_b, a.k_b, a.v_b};
  bool nan_seen = false;
  for (int u = warp; u < 4 * CG_G; u += NTHREADS / 32) {
    const int mt = u / CG_G, grp = u - mt * CG_G;
    float acc[6][4];
#pragma unroll
    for (int j = 0; j < 6; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < CG_CPG / 16; ++ks) {
      unsigned af[4];
      load_a(af, xs + 16 * mt * CG_LDX + CG_CPG * grp + 16 * ks, CG_LDX,
             lane);
#pragma unroll
      for (int np = 0; np < 3; ++np) {
        unsigned bf[4];
        load_b_kn(bf, wqkv + 16 * ks * CG_LDW + 16 * np, CG_LDW, lane);
        mma_bf16_16816(acc[2 * np], af, bf);
        mma_bf16_16816(acc[2 * np + 1], af, bf + 2);
      }
    }
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      const int w = j >> 1, c = 8 * (j & 1) + 2 * t;
      const float b0 = bias[w][c], b1 = bias[w][c + 1];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float v0 = dense_out(acc[j][2 * hf], b0);
        const float v1 = dense_out(acc[j][2 * hf + 1], b1);
        nan_seen = nan_seen || isnan(v0) || isnan(v1);
        store_bf16x2(dst[w] + (16 * mt + g + 8 * hf) * CG_LDQ +
                         CG_CPERG * grp + c,
                     pack_bf16x2(v0, v1));
      }
    }
  }
  return nan_seen;
}

// Head h's channels of a group's 16: channels 2t, 2t + 1 of lane t's
// fragments are head t / 2, channels 2t + 8, 2t + 9 head 2 + t / 2.
// head_a: an A fragment (16 rows x the 16 channels) with the other heads'
// channels zeroed; head_b: load_b_nk's two n8 tiles (k = the 16 channels)
// the same.  By selects: a product with a zero would make an inf or NaN
// of another head a NaN in this one.
__device__ __forceinline__ void head_a(const unsigned (&in)[4], int h,
                                       unsigned (&out)[4]) {
  const int th = (threadIdx.x & 3) >> 1;
  const bool lo = th == h, hi = th + 2 == h;
  out[0] = lo ? in[0] : 0u;
  out[1] = lo ? in[1] : 0u;
  out[2] = hi ? in[2] : 0u;
  out[3] = hi ? in[3] : 0u;
}

__device__ __forceinline__ void head_b(const unsigned (&in)[4], int h,
                                       unsigned (&out)[4]) {
  const int th = (threadIdx.x & 3) >> 1;
  const bool lo = th == h, hi = th + 2 == h;
  out[0] = lo ? in[0] : 0u;
  out[1] = hi ? in[1] : 0u;
  out[2] = lo ? in[2] : 0u;
  out[3] = hi ? in[3] : 0u;
}

// A product whose n is the 16 channels (load_b_kn's two n8 tiles) gives
// head h's four in n8 tile h / 2, held by the lanes with t / 2 == h % 2.
__device__ __forceinline__ bool head_lane(int h) {
  return ((threadIdx.x & 3) >> 1) == (h & 1);
}

// That n8 tile's B fragment out of load_b_kn's two, by selects (an index
// that is not a constant would put the fragments in local memory)
struct Frag2 {
  unsigned r[2];
};

__device__ __forceinline__ Frag2 head_tile(const unsigned (&b)[4], int h) {
  const bool hi = (h >> 1) != 0;
  return Frag2{{hi ? b[2] : b[0], hi ? b[3] : b[1]}};
}

// Head h's softmax probabilities of one warp's 16 queries (qa: their A
// fragment over the group's 16 channels) over NKT tiles of 16 keys (kf:
// load_b_nk fragments over the same channels), keys from nkeys on
// masked, scores divided by sqrt(4) as attention_core divides them (a
// power of two: the product by 1/2 is the same number); left in s in the
// C-fragment layout.
template <int NKT>
__device__ __forceinline__ void cga_probs(const unsigned (&qa)[4],
                                          const unsigned (&kf)[NKT][4], int h,
                                          int nkeys, float (&s)[2 * NKT][4]) {
  unsigned a[4];
  head_a(qa, h, a);
#pragma unroll
  for (int j = 0; j < 2 * NKT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int np = 0; np < NKT; ++np) {
    unsigned b[4];
    head_b(kf[np], h, b);
    mma_bf16_16816(s[2 * np], a, b);
    mma_bf16_16816(s[2 * np + 1], a, b + 2);
  }
  softmax_c<NKT, true>(s, nkeys, sqrtf((float)CG_HD));
}

// The attention of one 16-query tile in one group, its four heads: q, the
// 16 query rows, and k, v, the group's own keys and values in NKT - 1
// tiles of 16 rows, each from the group's first channel (leading dim
// ld); kb, vb the projected bank's 16 rows (leading dim CG_LDB); keys from
// nkeys on masked.  The output's 16 rows go to out (leading dim ld, the
// group's first channel) rounded to bf16.  TRAIN: the probabilities
// through the attention dropout am (am.vh: the group's first virtual
// head).  True if an output is NaN.  RECIP: a kept probability scaled
// by the product with 1 / keep (attn_mask_r), within an ulp of the
// quotient and no IEEE division an element (the n = 64 training
// instance).
template <int NKT, bool TRAIN, bool RECIP = false>
__device__ __forceinline__ bool cga_attend(const bf16* q, const bf16* k,
                                           const bf16* v, int ld,
                                           const bf16* kb, const bf16* vb,
                                           int nkeys, AttnMask am, bf16* out) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float inv_keep = RECIP ? 1.f / am.dr.keep : 1.f;
  unsigned qa[4], kf[NKT][4], vf[NKT][4];
  load_a(qa, q, ld, lane);
#pragma unroll
  for (int i = 0; i < NKT - 1; ++i) {
    load_b_nk(kf[i], k + 16 * i * ld, ld, lane);
    load_b_kn(vf[i], v + 16 * i * ld, ld, lane);
  }
  load_b_nk(kf[NKT - 1], kb, CG_LDB, lane);
  load_b_kn(vf[NKT - 1], vb, CG_LDB, lane);
  const int vh0 = am.vh;
  bool nan_seen = false;
#pragma unroll 1
  for (int h = 0; h < CG_H; ++h) {
    float s[2 * NKT][4];
    cga_probs<NKT>(qa, kf, h, nkeys, s);
    am.vh = vh0 + h;
    float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < NKT; ++kk) {
      unsigned pa[4];
      c_to_a<NKT>(s, kk, [&](int row, int key, float p) {
        if constexpr (RECIP) return attn_mask_r(am, row, key, p, inv_keep);
        if constexpr (TRAIN) return attn_mask(am, row, key, p);
        return p;
      }, pa);
      mma_bf16_16816(o, pa, head_tile(vf[kk], h).r);
    }
    if (head_lane(h))
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        nan_seen = nan_seen || isnan(o[2 * hf]) || isnan(o[2 * hf + 1]);
        store_bf16x2(out + (g + 8 * hf) * ld + 8 * (h >> 1) + 2 * t,
                     pack_bf16x2(o[2 * hf], o[2 * hf + 1]));
      }
  }
  return nan_seen;
}

// The forward kernel's body: NS samples a tile (1: n = 64, 4: n = 16),
// TRAIN the training instances.  It declares the dynamic shared
// memory itself, as window_mma does.
template <int NS, bool TRAIN>
__device__ __forceinline__ void cga_mma(const CgaMmaArgs& m) {
  constexpr int SN = CG_ROWS / NS;         // rows of a sample
  constexpr int NKT = SN / 16 + 1;         // key tiles: own, then the bank
  static_assert(NS == 1 || NS == 4, "one sample of 64 or four of 16");
  // the n = 64 training instance: the projected bank on the tensor cores,
  // both dropouts as products with 1 / keep, and part_k formed after the
  // blocks' sum (bank_store_sums, qv_bank_compress)
  constexpr bool N64T = NS == 1 && TRAIN;
  QV_SMEM_DECL
  CGA_FWD_STAMP(-1);
  __shared__ int bad;
  const CgaArgs& a = m.f;
  const Dims& d = a.d;
  const int S = d.bank_s, C = CG_C;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  bf16* wqkv = reinterpret_cast<bf16*>(qv_smem);   // [32][CG_LDW]
  bf16* wp = wqkv + CG_W_QKV;                      // [96][CG_LDX]
  bf16* kbp = wp + CG_W_PROJ;                      // [16][CG_LDB]
  bf16* vbp = kbp + CG_S * CG_LDB;
  bf16* xs = vbp + CG_S * CG_LDB;                  // [64][CG_LDX]
  bf16* q = xs + CG_XS;                            // [64][CG_LDQ] each
  bf16* k = q + CG_QB;
  bf16* v = k + CG_QB;
  bf16* att = v + CG_QB;
  bf16* out = att + CG_QB;                         // [64][CG_LDX]
  // training: the bank partials' scratch
  float* scratch = reinterpret_cast<float*>(out + CG_XS);

  if (threadIdx.x == 0) bad = 0;
  __syncthreads();
  // per block: the two kernels (cp.async; the first tile's wait completes
  // them) and the projected bank
  stage_weight(wqkv, CG_LDW, m.qkv_w16, CG_CPG, CG_QKV);
  stage_weight(wp, CG_LDX, m.proj_w16, CG_GW, C);
  cp_async_commit();
  if constexpr (N64T) {
    static_assert(2 * CG_BSTAGE <= 4 * BP_SCRATCH,
                  "the bank's staging in the partials' scratch");
    if (cga_bank_proj_mma(a, kbp, vbp, reinterpret_cast<bf16*>(scratch)) &&
        d.guard)
      bad = 1;
  } else if (cga_bank_proj(a, kbp, vbp) && d.guard) {
    bad = 1;
  }
  CGA_FWD_STAMP(0);

  const int tiles = (d.B * SN + CG_ROWS - 1) / CG_ROWS;
  // the rows of tile tl that hold samples
  auto valid_rows = [&](int tl) {
    const int r = d.B * SN - tl * CG_ROWS;
    return r < CG_ROWS ? r : CG_ROWS;
  };
  // a tile's rows from shared memory to device memory, 16 bytes a copy
  auto store_rows = [&](bf16* dst, const bf16* src, int valid) {
    for (int i = threadIdx.x; i < valid * (C / 8); i += blockDim.x) {
      const int r = i / (C / 8), c = (i - r * (C / 8)) * 8;
      *reinterpret_cast<uint4*>(dst + r * C + c) =
          *reinterpret_cast<const uint4*>(src + r * CG_LDX + c);
    }
  };
  // tile tl's rows of xn into xs (zeros past its samples')
  auto stage_x = [&](int tl) {
    const bf16* src = static_cast<const bf16*>(a.xn) + (size_t)tl * CG_ROWS * C;
    const int valid = valid_rows(tl);
    for (int i = threadIdx.x; i < CG_ROWS * (C / 8); i += blockDim.x) {
      const int r = i / (C / 8), c = (i - r * (C / 8)) * 8;
      if (r < valid)
        cp_async_16(xs + r * CG_LDX + c, src + r * C + c);
      else
        *reinterpret_cast<uint4*>(xs + r * CG_LDX + c) =
            uint4{0u, 0u, 0u, 0u};
    }
    cp_async_commit();
  };
  // proj's dense epilogue, through the proj dropout in training (row r
  // of tile tl: the tiles' rows are the batch's in order)
  const float inv_keep = N64T ? 1.f / d.keep : 1.f;
  auto proj_out = [&](int tl, int r, int col, float acc, float bias) {
    const float y = dense_out(acc, bias);
    if constexpr (N64T)
      return rnd<bf16>(drop_r(d, CGA_PROJ,
                              (unsigned)(((size_t)tl * CG_ROWS + r) * C + col),
                              y, inv_keep));
    if constexpr (TRAIN)
      return rnd<bf16>(
          drop(d, CGA_PROJ, (unsigned)(((size_t)tl * CG_ROWS + r) * C + col),
               y));
    return y;
  };
  BankSums sums;
  if constexpr (TRAIN) bank_sums_zero(sums);

  if ((int)blockIdx.x < tiles) stage_x(blockIdx.x);
  for (int tl = blockIdx.x; tl < tiles; tl += gridDim.x) {
    const int valid = valid_rows(tl);
    cp_async_wait<0>();
    __syncthreads();
    CGA_FWD_STAMP(1);
    if (cga_qkv(xs, wqkv, a, q, k, v) && d.guard) bad = 1;
    __syncthreads();
    CGA_FWD_STAMP(2);
    // xs is free: bring the next tile's rows while this one finishes
    if (tl + (int)gridDim.x < tiles) stage_x(tl + gridDim.x);
    {  // the attention: warp w the units (query tile, group) w, w + 8, w + 16
      bool nan_seen = false;
      for (int u = warp; u < 4 * CG_G; u += NTHREADS / 32) {
        const int mt = u / CG_G, grp = u - mt * CG_G;
        const int kr = NS == 1 ? 0 : 16 * mt;    // the sample's first row
        AttnMask am{no_drop(), 0u, grp * CG_H, NT + S};
        if constexpr (TRAIN) {
          // the sample's mask [G H, SN, SN + S]: sample NS tl + mt (n = 16)
          // or tl, whose query rows 16 mt.. the warp holds (n = 64)
          const int smp = NS == 1 ? tl : NS * tl + mt;
          am = AttnMask{attn_drop(d, CGA_ATTN),
                        (unsigned)(smp * CG_G * CG_H * SN + 16 * mt - kr) *
                            (SN + S),
                        grp * CG_H, SN + S, SN};
        }
        const int c0 = CG_CPERG * grp;
        nan_seen |= cga_attend<NKT, TRAIN, N64T>(
            q + 16 * mt * CG_LDQ + c0, k + kr * CG_LDQ + c0,
            v + kr * CG_LDQ + c0, CG_LDQ, kbp, vbp, SN + S, am,
            att + 16 * mt * CG_LDQ + c0);
      }
      if (d.guard && nan_seen) bad = 1;
    }
    __syncthreads();
    CGA_FWD_STAMP(3);
    {  // proj = att @ W_p + b: warp w rows 16 (w % 4).., columns 96 (w / 4)..
      const int mt = warp & 3, n0 = 96 * (warp >> 2);
      float acc[12][4];
#pragma unroll
      for (int j = 0; j < 12; ++j)
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < CG_GW / 16; ++ks) {
        unsigned af[4];
        load_a(af, att + 16 * mt * CG_LDQ + 16 * ks, CG_LDQ, lane);
#pragma unroll
        for (int np = 0; np < 6; ++np) {
          unsigned bf[4];
          load_b_kn(bf, wp + 16 * ks * CG_LDX + n0 + 16 * np, CG_LDX, lane);
          mma_bf16_16816(acc[2 * np], af, bf);
          mma_bf16_16816(acc[2 * np + 1], af, bf + 2);
        }
      }
#pragma unroll
      for (int j = 0; j < 12; ++j) {
        const int col = n0 + 8 * j + 2 * t;
        const float b0 = a.proj_b[col], b1 = a.proj_b[col + 1];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = 16 * mt + g + 8 * hf;
          store_bf16x2(out + r * CG_LDX + col,
                       pack_bf16x2(proj_out(tl, r, col, acc[j][2 * hf], b0),
                                   proj_out(tl, r, col + 1,
                                            acc[j][2 * hf + 1], b1)));
        }
      }
    }
    __syncthreads();
    CGA_FWD_STAMP(4);
    store_rows(static_cast<bf16*>(a.out) + (size_t)tl * CG_ROWS * C, out,
               valid);
    if constexpr (TRAIN)
      bank_tile_partials<SN>(out, CG_LDX, valid, a.bw, S, scratch, sums);
    CGA_FWD_STAMP(5);
  }
  // this block's slice of the partials
  auto store_partials = [&] {
    float* part = a.bw.part + (size_t)blockIdx.x * 2 * S * C;
    if constexpr (N64T)
      bank_store_sums(sums, S, scratch, part);
    else
      bank_store_partials(sums, a.bw, S, scratch, part);
  };
  if constexpr (TRAIN) store_partials();
  CGA_FWD_STAMP(6);
  if (d.guard)
    finish_guard(a.ws, bad, [&] {
      // the redo: a zero attention output, so every row of every sample
      // is proj(0) = rnd(rnd(0) + rnd(bias)), through the proj dropout in
      // training; there every block's partials restart here, this block
      // summing the whole batch's
      bf16* dst = static_cast<bf16*>(a.out);
      if constexpr (TRAIN) {
        for (int i = threadIdx.x; i < d.grid * 2 * S * C; i += blockDim.x)
          a.bw.part[i] = 0.f;
        bank_sums_zero(sums);
        for (int tl = 0; tl < tiles; ++tl) {
          const int valid = valid_rows(tl);
          for (int i = threadIdx.x; i < CG_ROWS * C / 2; i += blockDim.x) {
            const int r = 2 * i / C, col = 2 * i - r * C;
            store_bf16x2(out + r * CG_LDX + col,
                         pack_bf16x2(proj_out(tl, r, col, 0.f,
                                              a.proj_b[col]),
                                     proj_out(tl, r, col + 1, 0.f,
                                              a.proj_b[col + 1])));
          }
          __syncthreads();
          store_rows(dst + (size_t)tl * CG_ROWS * C, out, valid);
          bank_tile_partials<SN>(out, CG_LDX, valid, a.bw, S, scratch,
                                 sums);
        }
        store_partials();
      } else {
        for (size_t i = threadIdx.x; i < (size_t)d.B * SN * C / 2;
             i += blockDim.x) {
          const int col = (int)(2 * i % C);
          store_bf16x2(dst + 2 * i,
                       pack_bf16x2(dense_out(0.f, a.proj_b[col]),
                                   dense_out(0.f, a.proj_b[col + 1])));
        }
      }
    });
  CGA_FWD_STAMP(7);
}

}  // namespace qv
