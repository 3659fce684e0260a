// Unit 3 of the fused block, backward: the VJP of the CGA branch.
//
// Replaces the TPU kernel qavit_tpu/kernels/fused_pallas.py:244 bwd_call
// (pallas_call at :245, bwd_kernel :219-242) for the core `cga`
// (fused_kernels.py:88), whose attention backward the JAX package writes
// by hand (fused_cores.py:315-353 _cga_attend_fn).
//
// Bound on the H100 at B=1024 (bf16): 3 x 6.3 MB moved (~5.6 us) against
// ~4 x 0.9 GFLOP (~4 us): the bytes bound it.
//
// float32 (and bf16 at widths cga_bwd_mma_kernel does not take),
// cga_bwd_kernel: per sample, recompute through cga_body (unit_cga.cuh,
// the forward's code, masks and NaN-guard flag replayed), then
// differentiate proj and the 24-virtual-head attention, whose bank keys
// and values are shared by the 6 groups (their gradients are summed over
// the groups), then the group-shared q/k/v Dense layers back to d(xn),
// written per sample in the working type.  The bank projections'
// gradients follow per sample from the summed bank-key/value cotangents.
// Weight and bank gradients go to this block's float32 slice; the
// reduction pass sums the slices in block order.  Latency-bound: one
// 256-thread block per SM, ~213 KB of shared memory (three [24, 16, 32]
// float32 score tensors), float32 FMAs.
//
// bf16 at hqavit_c100's widths, cga_bwd_mma_kernel: every product on the
// tensor cores (mma.sync m16n8k16, bf16 operands, float32 sums), passes of
// four samples (64 rows), every activation and cotangent as bf16 in shared
// memory (150 KB), the weights resident.  Per pass: the unit recomputed
// through the forward's pieces (cga_mma.cuh: q | k | v, the attention with
// its dropout replayed); d(att) = d(out) @ W_p^T; the attention backward
// per (16 queries, group) and head in registers (cga_attend_bwd); d(xn) =
// d(q | k | v) @ W_qkv^T per group in one product.  Each pass saves the
// dense layers' operand rows to a per-block scratch (proj's per row, the
// q/k/v kernel's per row and group), and at the end the block forms their
// weight gradients over all its rows (wgrad_block).  The bank rows are
// the same for every sample, so the block sums the projected bank keys'
// and values' cotangents over its samples and groups (each warp in
// registers, then the warps in order) and forms the bank projections'
// and the bank rows' gradients from the sums once.  Every field of the
// block's slice is stored once, without reading it, so the caller's
// workspace needs no zeroing.  Time: PERF.md section 6 row 7.
//
// bf16 at hqavit_tiny_in's widths, n = 64, cga_bwd_mma64_kernel: one
// thread-block cluster of two CTAs a sample, CTA rank h its channel
// groups 3h..3h+2 (a group reads only its own 32 xn columns and makes
// only its own q, k, v and att columns), 104 KB of shared memory and at
// most 128 registers a thread, so two CTAs share an SM; its 64 keys and
// the bank's 16 a group-head, the recompute and the attention backward a
// warp per (group, head) over the sample's four query tiles
// (cga_head_fwd64, cga_head_bwd64).  The pair's sums of the shared
// weights' gradients (the q | k | v kernels, the bank cotangents) meet
// through distributed shared memory in rank order; one gradient slice a
// cluster.  Bound at B=128 on the H100: 9.7 MB against 2.1 GFLOP (~2.9
// us): the bytes bound it.  Time: PERF.md section 6 row 7 @n64.
#include "cga_mma.cuh"
#include "cluster.cuh"
#include "unit_cga.cuh"

namespace qv {

__host__ __device__ inline int cga_bwd_smem_floats(const Dims& d) {
  const int c = d.c, gw = d.groups * d.cperg, S = d.bank_s;
  const int kvn = pad4(d.groups * d.heads * NT * (NT + S));
  return NT * c                 // xs
         + 3 * NT * gw          // q, k, v, then d(q), -, d(v)
         + 2 * S * d.cperg      // projected bank k, v
         + NT * gw              // att
         + NT * c               // out during the recompute, d(out), d(xn)
         + NT * gw              // d(att)
         + NT * gw              // d(k)
         + 2 * S * d.cperg      // d(projected bank k, v)
         + 3 * kvn;             // P, PV probabilities, d(scores)
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS, 1) cga_bwd_kernel(CgaBwdArgs a) {
  QV_SMEM_DECL
  __shared__ int bad;
  const CgaArgs& f = a.f;
  const Dims& d = f.d;
  const int c = d.c, S = d.bank_s, gg = d.groups, cperg = d.cperg, h = d.heads;
  const int gw = gg * cperg, cpg = c / gg, VH = gg * h;
  const int kvn = pad4(VH * NT * (NT + S));
  float* xs = qv_smem;
  float* q = xs + NT * c;
  float* k = q + NT * gw;
  float* v = k + NT * gw;
  float* kbp = v + NT * gw;
  float* vbp = kbp + S * cperg;
  float* att = vbp + S * cperg;
  float* dO = att + NT * gw;
  float* dA = dO + NT * c;
  float* dk = dA + NT * gw;
  float* dkbp = dk + NT * gw;
  float* dvbp = dkbp + S * cperg;
  float* sc = dvbp + S * cperg;
  float* pr = sc + kvn;
  float* dp = pr + kvn;
  const CgaBufs s{xs, q, k, v, kbp, vbp, att, dO, sc, pr};
  const CgaGrads& g = a.g;
  const bool zero_attn = d.guard && a.c.flag[1] != 0;

  cga_prologue<T>(f, a.c.bank_kr, a.c.bank_vr, nullptr, s);
  for (int b = blockIdx.x; b < d.B; b += gridDim.x) {
    const size_t off = (size_t)b * NT * c;
    cga_body<T>(f, b, zero_attn, s, &bad);
    // proj dropout and proj
    load_tile<T>(dO, static_cast<const T*>(a.d_out) + off, NT * c);
    fill(dkbp, 2 * S * cperg, 0.f);
    __syncthreads();
    drop_rows(d, CGA_PROJ, (unsigned)(b * NT * c), dO, NT * c);
    __syncthreads();
    dense_wgrad(att, gw, 0, NT, gw, dO, c, c, 1, slice(g.proj_w, a.c), c,
                slice(g.proj_b, a.c));
    dense_dgrad<T>(dO, c, NT, c, f.proj_w, c, gw, 1, 0, dA, gw, false);
    __syncthreads();
    // a guarded branch passes zero gradient through its attention, so
    // nothing before it gets any
    if (zero_attn) {
      fill(dO, NT * c, 0.f);
      __syncthreads();
    } else {
      // attention: d(q) over q, d(v) over v, d(k) in dk
      attention_bwd<T>(q, gw, NT, VH, cperg / h, k, v, gw, NT, kbp, vbp, cperg,
                       S, h, dA, gw, sc, pr, dp, attn_drop(d, CGA_ATTN),
                       (unsigned)b * VH * NT * (NT + S), q, gw, dk, v, gw,
                       dkbp, dvbp, cperg);
      // the group-shared q/k/v Dense layers
      dense_wgrad(xs, c, cpg, NT, cpg, q, gw, cperg, gg, slice(g.q_w, a.c),
                  cperg, slice(g.q_b, a.c));
      dense_wgrad(xs, c, cpg, NT, cpg, dk, gw, cperg, gg, slice(g.k_w, a.c),
                  cperg, slice(g.k_b, a.c));
      dense_wgrad(xs, c, cpg, NT, cpg, v, gw, cperg, gg, slice(g.v_w, a.c),
                  cperg, slice(g.v_b, a.c));
      __syncthreads();
      dense_dgrad<T>(q, gw, NT, cperg, f.q_w, cperg, cpg, gg, cpg, dO, c,
                     false);
      __syncthreads();
      dense_dgrad<T>(dk, gw, NT, cperg, f.k_w, cperg, cpg, gg, cpg, dO, c,
                     true);
      __syncthreads();
      dense_dgrad<T>(v, gw, NT, cperg, f.v_w, cperg, cpg, gg, cpg, dO, c,
                     true);
      // the bank projections
      dense_wgrad(a.c.bank_kr, c, 0, S, c, dkbp, cperg, cperg, 1,
                  slice(g.bk_w, a.c), cperg, slice(g.bk_b, a.c));
      dense_wgrad(a.c.bank_vr, c, 0, S, c, dvbp, cperg, cperg, 1,
                  slice(g.bv_w, a.c), cperg, slice(g.bv_b, a.c));
      dense_dgrad<T>(dkbp, cperg, S, cperg, f.bk_w, cperg, c, 1, 0,
                     slice(g.bank_k, a.c), c, true);
      dense_dgrad<T>(dvbp, cperg, S, cperg, f.bv_w, cperg, c, 1, 0,
                     slice(g.bank_v, a.c), c, true);
      __syncthreads();
    }
    store_tile<T>(static_cast<T*>(a.d_xn) + off, dO, NT * c);
    __syncthreads();
  }
}

}  // namespace qv

extern "C" int qv_unit_cga_bwd(const qv::CgaBwdArgs* a, int is_bf16,
                               void* stream) {
  const qv::Dims& d = a->f.d;
  const size_t smem = qv::cga_bwd_smem_floats(d) * sizeof(float);
  const int rc =
      is_bf16 ? qv_launch(qv::cga_bwd_kernel<qv::bf16>, *a, smem, stream,
                          d.grid)
              : qv_launch(qv::cga_bwd_kernel<float>, *a, smem, stream, d.grid);
  if (rc != 0) return rc;
  return qv_reduce(a->c.gws, a->c.grad, d.grid, a->c.wstride, d.rgrid, stream);
}

extern "C" int qv_unit_cga_bwd_smem(const qv::Dims* d) {
  return qv::cga_bwd_smem_floats(*d) * (int)sizeof(float);
}

// --- bf16 at hqavit_c100's widths: the tensor-core kernel --------------------

QV_STAMPS_DEFINE(cga_bwd,
                 "weights and bank projections,stage,recompute,"
                 "proj bwd,attention bwd,q|k|v bwd and d(xn),"
                 "bank gradients,weight gradients")

namespace qv {

struct CgaBwdMmaArgs {
  CgaBwdArgs a;           // the float32 kernel's arguments
  // bf16 [32, 48] q | k | v | [96, 192] proj | [48, 32] q | k | v^T |
  // [192, 96] proj^T
  const bf16* w;
};

constexpr int CB_QKV = 0, CB_QKVT = CG_CPG * CG_QKV + CG_GW * CG_C;
constexpr int CB_PROJT = CB_QKVT + CG_QKV * CG_CPG;
constexpr int CB_LDT = CG_CPG + 8;      // q | k | v^T's and dS's, P's rows
constexpr int CB_LDPT = CG_GW + 8;      // proj^T's rows
// a block's saved operand rows (bf16; wgrad_block's inputs): per row of a
// pass, proj's input and d(out); per row and group, the group's xn
// columns and d(q | k | v)
constexpr int CB_OPP = CG_GW + CG_C;
constexpr int CB_OPQ = CG_CPG + CG_QKV;
// shared memory, in bf16 elements: the three kernels, the projected bank,
// xn and d(out) [64, C], q, k, v, att [64, 96]
constexpr int CB_W = CG_CPG * CG_LDW + CG_QKV * CB_LDT + CG_C * CB_LDPT;
constexpr int CB_SMEM_BYTES = 2 * (CB_W + CG_BANK + 2 * CG_XS + 4 * CG_QB);
// each warp's dS and P [16, 32] keys, in d(out)'s space once d(att) is
// formed; the warps' bank sums [8][2][16][16] floats, in q's at the end
static_assert(8 * 2 * NT * CB_LDT <= CG_XS, "the warps' dS and P");
static_assert(8 * 2 * 2 * 256 + 2 * 256 <= 4 * CG_QB, "the bank sums");

// per block: the operand rows of its passes (bf16; a pass four samples:
// 64 rows of proj's, 6 x 64 of the q/k/v kernel's)
__host__ __device__ inline int cga_bwd_mma_scratch_floats(const Dims& d) {
  const int nb = (d.B + d.grid - 1) / d.grid;
  return CG_ROWS * ((nb + 3) / 4) * (CB_OPP + CG_G * CB_OPQ) / 2;
}

// The backward of cga_attend (training, n = 16: the sample's 16 keys and
// the bank's) for one 16-query tile in one group, its four heads, given
// d(att) dA (the 16 rows at the group's first channel, leading dim ld, as
// q, k, v): per head, P recomputed, dP = dA V^T through the mask am, dS =
// P (dP - rowsum(dP P)) / sqrt(4) as warp_attention_bwd; dq = dS K, the
// sample's keys' dK = dS^T q and dV = P^T dA, each head's four channels
// written over its own in q, k, v once the head's reads are done (a later
// head's products read other channels only: head_a and head_b select
// them, and a product over keys or queries gives each channel from its
// own column); the bank keys' and values' cotangents (keys x the group's
// 16 channels) added to gkb, gvb.  ws: the warp's dS, then P, 16 x
// CB_LDT each.
__device__ __forceinline__ void cga_attend_bwd(bf16* q, bf16* k, bf16* v,
                                               const bf16* dA, int ld,
                                               const bf16* kb, const bf16* vb,
                                               int nkeys, AttnMask am,
                                               bf16* ws, float (&gkb)[2][4],
                                               float (&gvb)[2][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float sqrt_d = sqrtf((float)CG_HD);
  bf16* ds = ws;
  bf16* pu = ws + NT * CB_LDT;
  unsigned qa[4], da[4], kf[2][4], vf[2][4];
  load_a(qa, q, ld, lane);
  load_a(da, dA, ld, lane);
  load_b_nk(kf[0], k, ld, lane);
  load_b_nk(kf[1], kb, CG_LDB, lane);
  load_b_nk(vf[0], v, ld, lane);
  load_b_nk(vf[1], vb, CG_LDB, lane);
  const int vh0 = am.vh;
#pragma unroll 1
  for (int h = 0; h < CG_H; ++h) {
    am.vh = vh0 + h;
    float s[4][4], dp[4][4];
    cga_probs<2>(qa, kf, h, nkeys, s);
    unsigned a[4];
    head_a(da, h, a);
#pragma unroll
    for (int j = 0; j < 4; ++j) dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      unsigned b[4];
      head_b(vf[np], h, b);
      mma_bf16_16816(dp[2 * np], a, b);
      mma_bf16_16816(dp[2 * np + 1], a, b + 2);
    }
    float dot0 = 0.f, dot1 = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = 8 * j + 2 * t + (e & 1), row = g + 8 * (e >> 1);
        dp[j][e] = attn_mask(am, row, key, dp[j][e]);
        if (e & 1)         // the probabilities PV used, for dV
          store_bf16x2(pu + row * CB_LDT + key - 1,
                       pack_bf16x2(attn_mask(am, row, key - 1, s[j][e - 1]),
                                   attn_mask(am, row, key, s[j][e])));
        if (e >> 1)
          dot1 = fmaf(dp[j][e], s[j][e], dot1);
        else
          dot0 = fmaf(dp[j][e], s[j][e], dot0);
      }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      dot0 += __shfl_xor_sync(0xffffffffu, dot0, o);
      dot1 += __shfl_xor_sync(0xffffffffu, dot1, o);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = s[j][e] * (dp[j][e] - (e >> 1 ? dot1 : dot0)) / sqrt_d;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        store_bf16x2(ds + (g + 8 * hf) * CB_LDT + 8 * j + 2 * t,
                     pack_bf16x2(s[j][2 * hf], s[j][2 * hf + 1]));
    }
    __syncwarp();
    // dq = dS K over the 32 keys; dK, dV of the sample's keys (0..15) and
    // the bank's (16..31)
    float oq[4] = {0.f, 0.f, 0.f, 0.f}, ok[4] = {0.f, 0.f, 0.f, 0.f};
    float ov[4] = {0.f, 0.f, 0.f, 0.f}, obk[4] = {0.f, 0.f, 0.f, 0.f};
    float obv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      unsigned pa[4], kn[4];
      c_to_a<2>(s, kk, [](int, int, float x) { return x; }, pa);
      load_b_kn(kn, kk ? kb : k, kk ? CG_LDB : ld, lane);
      mma_bf16_16816(oq, pa, head_tile(kn, h).r);
    }
    {
      unsigned at[4], bq[4], bd[4];
      load_b_kn(bq, q, ld, lane);
      load_b_kn(bd, dA, ld, lane);
      load_a_t(at, ds, CB_LDT, lane);
      mma_bf16_16816(ok, at, head_tile(bq, h).r);
      load_a_t(at, ds + 16, CB_LDT, lane);
      mma_bf16_16816(obk, at, head_tile(bq, h).r);
      load_a_t(at, pu, CB_LDT, lane);
      mma_bf16_16816(ov, at, head_tile(bd, h).r);
      load_a_t(at, pu + 16, CB_LDT, lane);
      mma_bf16_16816(obv, at, head_tile(bd, h).r);
    }
    __syncwarp();          // every lane's reads of this head are done
    if (head_lane(h)) {
      const int c = 8 * (h >> 1) + 2 * t;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = (g + 8 * hf) * ld + c;
        store_bf16x2(q + r, pack_bf16x2(oq[2 * hf], oq[2 * hf + 1]));
        store_bf16x2(k + r, pack_bf16x2(ok[2 * hf], ok[2 * hf + 1]));
        store_bf16x2(v + r, pack_bf16x2(ov[2 * hf], ov[2 * hf + 1]));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (h >> 1) {
          gkb[1][e] += obk[e];
          gvb[1][e] += obv[e];
        } else {
          gkb[0][e] += obk[e];
          gvb[0][e] += obv[e];
        }
      }
    }
    __syncwarp();          // the next head's dS, P after these reads
  }
}

// n = 64 (cga_bwd_mma64_kernel): a cluster of two CTAs a sample, CTA
// rank h the channel groups 3h..3h+2 (C6_*); the sample's 64 keys and the
// bank's 16 a group-head
constexpr int CB_NKT64 = 5;                   // key tiles
constexpr int CB_LDT64 = 16 * CB_NKT64 + 8;   // the warps' dS's, P's rows
constexpr int C6_G = CG_G / 2;                // groups of a CTA
constexpr int C6_GW = C6_G * CG_CPERG;        // 48: its q, k, v, att columns
constexpr int C6_XW = C6_G * CG_CPG;          // 96: its xn columns
constexpr int C6_LDQ = C6_GW + 8, C6_LDXS = C6_XW + 8, C6_LDPT = C6_GW + 8;
constexpr int C6_QB = CG_ROWS * C6_LDQ;       // [64, 48] rows
// the warps' space: xs and d(out), then the warps' P and dS
constexpr int C6_WS = CG_ROWS * C6_LDXS + CG_XS;
static_assert(8 * NT * CB_LDT64 <= C6_WS, "the warps' P and dS");
// a warp's float32 sums, each C fragment of its 16 head lanes: dK and dV
// of the sample's four key tiles (over a unit's query tiles), then of the
// bank's (over the warp's units)
constexpr int C6_SUMS = 2 * 5 * 16 * 4;
// shared memory in bf16 elements: the q | k | v kernels, proj^T's rows
// for the CTA's att columns, the projected bank, the warps' space, q, k,
// v, att, the warps' sums
constexpr int C6_BF16 = CG_CPG * CG_LDW + CG_C * C6_LDPT + CG_BANK + C6_WS +
                        4 * C6_QB + 8 * C6_SUMS * 2;
constexpr int C6_SMEM_BYTES = 2 * C6_BF16;
static_assert(C6_SMEM_BYTES <= 232448 / 2 - 1024, "two CTAs on an SM");
// the end's float32 sums in q..att's space: the warps' bank sums
// [8][2][256], the CTA's [2][256], the q | k | v kernels' and biases'
// gradients [3][32 x 16] | [3][16], the pair's bank sums [256]
constexpr int C6_DKB = 8 * 2 * 256, C6_PQ = C6_DKB + 2 * 256;
constexpr int C6_NPQ = 3 * (CG_CPG * CG_CPERG + CG_CPERG);
constexpr int C6_TOT = C6_PQ + C6_NPQ;
static_assert((C6_TOT + 256) * 2 <= 4 * C6_QB, "the end's sums");
// a CTA's operand rows (bf16): per row, its att columns and d(out); per
// row and group, the group's xn columns and d(q | k | v)
constexpr int C6_OPP = C6_GW + CG_C;

// n = 64, a warp's (group, head) unit: key tile kt's rows of the
// sample's k or v (kt < 4, leading dim ld), else the bank's (CG_LDB)
__device__ __forceinline__ const bf16* key_tile64(const bf16* own,
                                                  const bf16* bank, int ld,
                                                  int kt) {
  return kt < CB_NKT64 - 1 ? own + 16 * kt * ld : bank;
}

// Head h's softmax probabilities of the 16 queries at qm over the 80
// keys, as cga_probs<5> forms them, the key fragments loaded a tile at a
// time (fewer live registers: the n = 64 backward runs two CTAs an SM)
__device__ __forceinline__ void head_probs64(const bf16* qm, const bf16* k,
                                             const bf16* kb, int ld, int h,
                                             int nkeys,
                                             float (&s)[2 * CB_NKT64][4]) {
  const int lane = threadIdx.x & 31;
  unsigned qa[4], a[4];
  load_a(qa, qm, ld, lane);
  head_a(qa, h, a);
#pragma unroll
  for (int j = 0; j < 2 * CB_NKT64; ++j)
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int np = 0; np < CB_NKT64; ++np) {
    unsigned kf[4], b[4];
    load_b_nk(kf, key_tile64(k, kb, ld, np), np < CB_NKT64 - 1 ? ld : CG_LDB,
              lane);
    head_b(kf, h, b);
    mma_bf16_16816(s[2 * np], a, b);
    mma_bf16_16816(s[2 * np + 1], a, b + 2);
  }
  softmax_c<CB_NKT64, true>(s, nkeys, sqrtf((float)CG_HD));
}

// The recompute of cga_attend<5, true> in head h of one group of one
// n = 64 sample, by one warp: per 16-query tile, P through the mask am
// (am.base the sample's, am.vh the head's virtual head) times V, the
// head's four output channels rounded to bf16 to out (leading dim ld, the
// group's first channel).  A kept probability is scaled by the product
// with 1 / keep (attn_mask_r), as the forward's cga_attend<5, true, true>
// scales it: an IEEE division an element was most of this kernel's
// attention time.
__device__ __forceinline__ void cga_head_fwd64(const bf16* q, const bf16* k,
                                               const bf16* v, int ld,
                                               const bf16* kb,
                                               const bf16* vb, int nkeys,
                                               AttnMask am, int h,
                                               bf16* out) {
  constexpr int NKT = CB_NKT64;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float inv_keep = 1.f / am.dr.keep;
  const unsigned base0 = am.base;
#pragma unroll 1
  for (int mt = 0; mt < 4; ++mt) {
    am.base = base0 + (unsigned)(16 * mt * am.kv);    // the tile's rows
    float s[2 * NKT][4];
    head_probs64(q + 16 * mt * ld, k, kb, ld, h, nkeys, s);
    float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < NKT; ++kk) {
      unsigned pa[4], vf[4];
      c_to_a<NKT>(s, kk, [&](int row, int key, float p) {
        return attn_mask_r(am, row, key, p, inv_keep);
      }, pa);
      load_b_kn(vf, key_tile64(v, vb, ld, kk), kk < NKT - 1 ? ld : CG_LDB,
                lane);
      mma_bf16_16816(o, pa, head_tile(vf, h).r);
    }
    if (head_lane(h))
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        store_bf16x2(out + (16 * mt + g + 8 * hf) * ld + 8 * (h >> 1) + 2 * t,
                     pack_bf16x2(o[2 * hf], o[2 * hf + 1]));
  }
}

// The C fragment of lane (g, t) for key tile kt's dK (w = 0) or dV (1) in
// a warp's sums (kt = 4: the bank's)
__device__ __forceinline__ float* c6_sum(float* sums, int w, int kt, int g,
                                         int t) {
  return sums + (((kt < CB_NKT64 - 1 ? w * 4 + kt : 8 + w) * 8 + g) * 2 +
                 (t & 1)) * 4;
}

// The backward of cga_attend<5, true> (training, n = 64) in head h of one
// group of one sample, its 64 queries, by one warp: per 16-query tile mt,
// P recomputed, dP = dA V^T through the mask am (am.base the sample's,
// am.vh the head's virtual head) formed twice, once for the rows' sums
// dot = rowsum(dP P) and once for dS = P (dP - dot) / sqrt(4) (fewer live
// registers than keeping dP: its kernel runs two CTAs an SM at 128
// registers a thread; each element's mask bit hashed once and kept, a
// kept value scaled by the product with 1 / keep, as attn_mask_r).  The
// probabilities PV used go to ws first, for dV = P^T dA; then dS, for dq
// = dS K (written over q's head-h channels of the tile once the tile's
// reads are done) and dK = dS^T q.  Every key tile's dK and dV go to the
// warp's float32 sums (C6_SUMS; each C fragment loaded into its product
// and stored back: the sums registers would hold, in none): the sample's
// keys' over the four query tiles, then written over k's and v's head-h
// channels; the bank's keys' (head h's n8 tile, head_tile) kept over the
// warp's units.  Only head lanes store a fragment: the others' hold other
// heads' channels.  A head keeps only its own channels: head_a and head_b
// select them, and a product over keys or queries gives each channel from
// its own column, so the warps of the group's other heads, writing their
// own channels meanwhile, change nothing this warp keeps.  ws: 16 x
// CB_LDT64 bf16.
__device__ __forceinline__ void cga_head_bwd64(bf16* q, bf16* k, bf16* v,
                                               const bf16* dA, int ld,
                                               const bf16* kb,
                                               const bf16* vb, int nkeys,
                                               AttnMask am, int h, bf16* ws,
                                               float* sums) {
  constexpr int NKT = CB_NKT64;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float inv_sqrt_d = 1.f / sqrtf((float)CG_HD);   // 1/2: exact
  const float inv_keep = 1.f / am.dr.keep;
  const unsigned base0 = am.base;
  auto krow = [&](const bf16* own, const bf16* bank, int kt) {
    return key_tile64(own, bank, ld, kt);
  };
  auto kld = [&](int kt) { return kt < NKT - 1 ? ld : CG_LDB; };
  // key tile kt's dK (w = 0) or dV (1) C fragment in the warp's sums
  const bool hl = head_lane(h);
  auto sum_at = [&](int w, int kt) { return c6_sum(sums, w, kt, g, t); };
  // C += A^T B over the tile's 16 queries into the sums of key tile kt
  auto add_tn = [&](int w, int kt, const unsigned (&at)[4],
                    const unsigned (&b)[2]) {
    float4 c = *reinterpret_cast<const float4*>(sum_at(w, kt));
    float acc[4] = {c.x, c.y, c.z, c.w};
    mma_bf16_16816(acc, at, b);
    if (hl)
      *reinterpret_cast<float4*>(sum_at(w, kt)) =
          float4{acc[0], acc[1], acc[2], acc[3]};
  };
  if (hl)
#pragma unroll
    for (int i = 0; i < 2 * (NKT - 1); ++i)
      *reinterpret_cast<float4*>(sum_at(i >> 2, i & 3)) =
          float4{0.f, 0.f, 0.f, 0.f};
#pragma unroll 1
  for (int mt = 0; mt < 4; ++mt) {
    am.base = base0 + (unsigned)(16 * mt * am.kv);    // the tile's rows
    bf16* qm = q + 16 * mt * ld;
    const bf16* dm = dA + 16 * mt * ld;
    float s[2 * NKT][4];
    head_probs64(qm, k, kb, ld, h, nkeys, s);
    unsigned da[4];
    {
      unsigned r[4];
      load_a(r, dm, ld, lane);
      head_a(r, h, da);
    }
    // dP of key tile np (keys 16 np..), before the mask
    auto dp_tile = [&](int np, float (&dp)[2][4]) {
      unsigned vf[4], b[4];
      load_b_nk(vf, krow(v, vb, np), kld(np), lane);
      head_b(vf, h, b);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
        dp[jj][0] = dp[jj][1] = dp[jj][2] = dp[jj][3] = 0.f;
      mma_bf16_16816(dp[0], da, b);
      mma_bf16_16816(dp[1], da, b + 2);
    };
    // element (j, e)'s mask bit (bit 4j + e of bits), and p through it as
    // attn_mask passes it
    unsigned bits[2] = {0u, 0u};
    auto masked = [&](int j, int e, float p) {
      if (!am.dr.on) return p;
      return (bits[j >> 3] >> (4 * (j & 7) + e)) & 1u ? p * inv_keep : 0.f;
    };
    float dot0 = 0.f, dot1 = 0.f;
#pragma unroll
    for (int np = 0; np < NKT; ++np) {
      float dp[2][4];
      dp_tile(np, dp);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 2 * np + jj;
          const int key = 8 * j + 2 * t + (e & 1), row = g + 8 * (e >> 1);
          if (am.dr.on &&
              kept(am.dr.salt, am.dr.thr,
                   am.base + (unsigned)((am.vh * am.nq + row) * am.kv + key)))
            bits[j >> 3] |= 1u << (4 * (j & 7) + e);
          if (e & 1)         // the probabilities PV used, for dV
            store_bf16x2(ws + row * CB_LDT64 + key - 1,
                         pack_bf16x2(masked(j, e - 1, s[j][e - 1]),
                                     masked(j, e, s[j][e])));
          const float dpm = masked(j, e, dp[jj][e]);
          if (e >> 1)
            dot1 = fmaf(dpm, s[j][e], dot1);
          else
            dot0 = fmaf(dpm, s[j][e], dot0);
        }
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      dot0 += __shfl_xor_sync(0xffffffffu, dot0, o);
      dot1 += __shfl_xor_sync(0xffffffffu, dot1, o);
    }
    __syncwarp();
    {  // dV = P^T dA of every key tile from this query tile
      unsigned bd[4];
      load_b_kn(bd, dm, ld, lane);
#pragma unroll
      for (int kt = 0; kt < NKT; ++kt) {
        unsigned at[4];
        load_a_t(at, ws + 16 * kt, CB_LDT64, lane);
        add_tn(1, kt, at, head_tile(bd, h).r);
      }
    }
    __syncwarp();          // every lane's reads of P are done
#pragma unroll
    for (int np = 0; np < NKT; ++np) {
      float dp[2][4];
      dp_tile(np, dp);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = 2 * np + jj;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = s[j][e] *
                    (masked(j, e, dp[jj][e]) - (e >> 1 ? dot1 : dot0)) *
                    inv_sqrt_d;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          store_bf16x2(ws + (g + 8 * hf) * CB_LDT64 + 8 * j + 2 * t,
                       pack_bf16x2(s[j][2 * hf], s[j][2 * hf + 1]));
      }
    }
    __syncwarp();
    // dq = dS K over the 80 keys; dK of every key tile from this tile
    float oq[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < NKT; ++kk) {
      unsigned pa[4], kn[4];
      load_a(pa, ws + 16 * kk, CB_LDT64, lane);
      load_b_kn(kn, krow(k, kb, kk), kld(kk), lane);
      mma_bf16_16816(oq, pa, head_tile(kn, h).r);
    }
    {
      unsigned bq[4];
      load_b_kn(bq, qm, ld, lane);
#pragma unroll
      for (int kt = 0; kt < NKT; ++kt) {
        unsigned at[4];
        load_a_t(at, ws + 16 * kt, CB_LDT64, lane);
        add_tn(0, kt, at, head_tile(bq, h).r);
      }
    }
    __syncwarp();          // every lane's reads of the tile are done
    if (hl) {
      const int c = 8 * (h >> 1) + 2 * t;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        store_bf16x2(qm + (g + 8 * hf) * ld + c,
                     pack_bf16x2(oq[2 * hf], oq[2 * hf + 1]));
    }
    __syncwarp();          // the next tile's P after these reads
  }
  if (hl) {
    const int c = 8 * (h >> 1) + 2 * t;
#pragma unroll
    for (int kt = 0; kt < NKT - 1; ++kt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = (16 * kt + g + 8 * hf) * ld + c;
        const float* ok = sum_at(0, kt);
        const float* ov = sum_at(1, kt);
        store_bf16x2(k + r, pack_bf16x2(ok[2 * hf], ok[2 * hf + 1]));
        store_bf16x2(v + r, pack_bf16x2(ov[2 * hf], ov[2 * hf + 1]));
      }
  }
  __syncwarp();            // the warp's next unit after these writes
}

// n = 16: one block per SM walks its samples b = blockIdx.x, blockIdx.x +
// grid, ... in passes of 64 rows, NS = 4 samples (a short last pass runs
// samples of zeros with a zero cotangent, which add nothing).  The [64, C]
// buffers of a pass: xs (xn), dO (d(out) through the proj dropout; then
// the warps' dS and P; then d(xn)); the [64, 96] ones: q, k, v, then
// d(q), d(k), d(v); att, then d(att).
__global__ void __launch_bounds__(NTHREADS, 1)
    cga_bwd_mma_kernel(CgaBwdMmaArgs m) {
  constexpr int NS = 4;                    // samples a pass
  QV_SMEM_DECL
  QV_STAMP(cga_bwd, -1);
  const CgaBwdArgs& a = m.a;
  const CgaArgs& f = a.f;
  const Dims& d = f.d;
  const CgaGrads& gr = a.g;
  const int S = d.bank_s, C = CG_C;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  bf16* wqkv = reinterpret_cast<bf16*>(qv_smem);   // [32][CG_LDW]
  bf16* wqkvt = wqkv + CG_CPG * CG_LDW;            // [48][CB_LDT]
  bf16* wpt = wqkvt + CG_QKV * CB_LDT;             // [192][CB_LDPT]
  bf16* kbp = wpt + CG_C * CB_LDPT;                // [16][CG_LDB]
  bf16* vbp = kbp + CG_S * CG_LDB;
  bf16* xs = vbp + CG_S * CG_LDB;                  // [64][CG_LDX]
  bf16* dO = xs + CG_XS;
  bf16* q = dO + CG_XS;                            // [64][CG_LDQ] each
  bf16* k = q + CG_QB;
  bf16* v = k + CG_QB;
  bf16* att = v + CG_QB;
  // this warp's dS, P
  bf16* wsc = dO + warp * 2 * NT * CB_LDT;
  const bool zero_attn = d.guard && a.c.flag[1] != 0;
  const int nb = (d.B - (int)blockIdx.x + (int)gridDim.x - 1) / gridDim.x;
  const int passes = (nb + NS - 1) / NS;
  const int rows_max = cga_bwd_mma_scratch_floats(d) * 2 /
                       (CB_OPP + CG_G * CB_OPQ);
  bf16* opp = reinterpret_cast<bf16*>(
      a.c.scratch + (size_t)blockIdx.x * cga_bwd_mma_scratch_floats(d));
  bf16* opq = opp + (size_t)rows_max * CB_OPP;

  // per block: the kernels (cp.async; the first pass's wait completes
  // them) and the projected bank
  stage_weight(wqkv, CG_LDW, m.w + CB_QKV, CG_CPG, CG_QKV);
  stage_weight(wqkvt, CB_LDT, m.w + CB_QKVT, CG_QKV, CG_CPG);
  stage_weight(wpt, CB_LDPT, m.w + CB_PROJT, CG_C, CG_GW);
  cp_async_commit();
  cga_bank_proj(f, kbp, vbp);
  // this warp's sums of the bank keys' and values' cotangents over its
  // units: keys g, g + 8 x channels 8j + 2t, 8j + 2t + 1 of the group's 16
  float gkb[2][4] = {}, gvb[2][4] = {};
  QV_STAMP(cga_bwd, 0);

  for (int p = 0; p < passes; ++p) {
    const int ns = nb - NS * p < NS ? nb - NS * p : NS;
    const int valid = ns * NT;             // the pass's rows of samples
    int bs[4];
#pragma unroll
    for (int s = 0; s < 4; ++s)
      bs[s] = (int)blockIdx.x + (NS * p + s) * (int)gridDim.x;
    // the flat token index of the pass's row r (the samples by selects:
    // an index into bs would go to memory)
    auto tok = [&](int r) {
      const int s = r >> 4;
      const int b = s == 0 ? bs[0] : s == 1 ? bs[1] : s == 2 ? bs[2] : bs[3];
      return b * NT + (r & 15);
    };
    // rows of the pass's samples from src, zeros past them
    auto stage = [&](bf16* dst, const void* src) {
      for (int i = threadIdx.x; i < CG_ROWS * (C / 8); i += blockDim.x) {
        const int r = i / (C / 8), c = (i - r * (C / 8)) * 8;
        bf16* to = dst + r * CG_LDX + c;
        if (r < valid)
          cp_async_16(to, static_cast<const bf16*>(src) +
                              (size_t)tok(r) * C + c);
        else
          *reinterpret_cast<uint4*>(to) = uint4{0u, 0u, 0u, 0u};
      }
    };
    // rows r of dO to d(xn) in device memory, the pass's samples only
    auto store_dxn = [&] {
      for (int i = threadIdx.x; i < valid * (C / 8); i += blockDim.x) {
        const int r = i / (C / 8), c = (i - r * (C / 8)) * 8;
        *reinterpret_cast<uint4*>(static_cast<bf16*>(a.d_xn) +
                                  (size_t)tok(r) * C + c) =
            *reinterpret_cast<const uint4*>(dO + r * CG_LDX + c);
      }
    };
    bf16* pp = opp + (size_t)p * CG_ROWS * CB_OPP;
    bf16* pq = opq + (size_t)p * CG_ROWS * CG_G * CB_OPQ;
    stage(xs, f.xn);
    stage(dO, a.d_out);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    QV_STAMP(cga_bwd, 1);
    // d(out) through the proj dropout
    if (d.train && d.drop_on)
      for (int i = threadIdx.x; i < CG_ROWS * C; i += blockDim.x) {
        const int r = i / C, c = i - r * C;
        bf16* e = dO + r * CG_LDX + c;
        *e = from_f<bf16>(drop(d, CGA_PROJ, (unsigned)(tok(r) * C + c),
                               to_f<bf16>(*e)));
      }
    if (zero_attn) {
      // a guarded branch: no gradient passes through its attention, so
      // only proj's bias learns (its input is zero), and d(xn) is zero
      for (int i = threadIdx.x; i < CG_QB; i += blockDim.x)
        att[i] = from_f<bf16>(0.f);
      __syncthreads();
      save_rows(pp, CB_OPP, att, CG_LDQ, CG_GW, CG_ROWS);
      save_rows(pp + CG_GW, CB_OPP, dO, CG_LDX, C, CG_ROWS);
      __syncthreads();
      for (int i = threadIdx.x; i < CG_XS; i += blockDim.x)
        dO[i] = from_f<bf16>(0.f);
      __syncthreads();
      store_dxn();
      __syncthreads();
      continue;
    }
    // ---- recompute ---------------------------------------------------
    cga_qkv(xs, wqkv, f, q, k, v);
    __syncthreads();
    for (int u = warp; u < 4 * CG_G; u += NTHREADS / 32) {
      const int mt = u / CG_G, grp = u - mt * CG_G, c0 = CG_CPERG * grp;
      const int r0 = 16 * mt * CG_LDQ + c0;
      const int b =
          mt == 0 ? bs[0] : mt == 1 ? bs[1] : mt == 2 ? bs[2] : bs[3];
      const AttnMask am{attn_drop(d, CGA_ATTN),
                        (unsigned)b * CG_G * CG_H * NT * (NT + S),
                        grp * CG_H, NT + S};
      cga_attend<2, true>(q + r0, k + r0, v + r0, CG_LDQ, kbp, vbp, NT + S,
                          am, att + r0);
    }
    __syncthreads();
    QV_STAMP(cga_bwd, 2);
    // ---- proj: its operand rows, then d(att) = d(out) @ W_p^T over att;
    // the q | k | v kernel's input columns (xn) of its operand rows (row,
    // group), before the n = 64 attention backward takes xs's space ----
    save_rows(pp, CB_OPP, att, CG_LDQ, CG_GW, CG_ROWS);
    save_rows(pp + CG_GW, CB_OPP, dO, CG_LDX, C, CG_ROWS);
    for (int i = threadIdx.x; i < CG_ROWS * CG_G * (CG_CPG / 8);
         i += blockDim.x) {
      const int rg = i / (CG_CPG / 8), c = (i - rg * (CG_CPG / 8)) * 8;
      const int r = rg / CG_G, grp = rg - r * CG_G;
      *reinterpret_cast<uint4*>(pq + (size_t)rg * CB_OPQ + c) =
          *reinterpret_cast<const uint4*>(xs + r * CG_LDX + CG_CPG * grp + c);
    }
    __syncthreads();
    {  // warp w: rows 16 (w % 4).., columns 48 (w / 4)..
      const int mt = warp & 3, n0 = 48 * (warp >> 2);
      float acc[6][4];
#pragma unroll
      for (int j = 0; j < 6; ++j)
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll 4
      for (int ks = 0; ks < C / 16; ++ks) {
        unsigned af[4];
        load_a(af, dO + 16 * mt * CG_LDX + 16 * ks, CG_LDX, lane);
#pragma unroll
        for (int np = 0; np < 3; ++np) {
          unsigned bf[4];
          load_b_kn(bf, wpt + 16 * ks * CB_LDPT + n0 + 16 * np, CB_LDPT,
                    lane);
          mma_bf16_16816(acc[2 * np], af, bf);
          mma_bf16_16816(acc[2 * np + 1], af, bf + 2);
        }
      }
#pragma unroll
      for (int j = 0; j < 6; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          store_bf16x2(att + (16 * mt + g + 8 * hf) * CG_LDQ + n0 + 8 * j +
                           2 * t,
                       pack_bf16x2(acc[j][2 * hf], acc[j][2 * hf + 1]));
    }
    __syncthreads();
    QV_STAMP(cga_bwd, 3);
    // ---- the attention: d(q), d(k), d(v) over q, k, v; the bank's sums --
    for (int u = warp; u < 4 * CG_G; u += NTHREADS / 32) {
      const int mt = u / CG_G, grp = u - mt * CG_G, c0 = CG_CPERG * grp;
      const int b =
          mt == 0 ? bs[0] : mt == 1 ? bs[1] : mt == 2 ? bs[2] : bs[3];
      const AttnMask am{attn_drop(d, CGA_ATTN),
                        (unsigned)b * CG_G * CG_H * NT * (NT + S),
                        grp * CG_H, NT + S};
      const int r0 = 16 * mt * CG_LDQ + c0;
      cga_attend_bwd(q + r0, k + r0, v + r0, att + r0, CG_LDQ, kbp, vbp,
                     NT + S, am, wsc, gkb, gvb);
    }
    __syncthreads();
    QV_STAMP(cga_bwd, 4);
    // ---- the q | k | v kernel: its operand rows' cotangent columns (row,
    // group), then d(xn) = d(q | k | v) @ W_qkv^T per group into dO's
    // space -------------------------------------------------------------
    for (int i = threadIdx.x; i < CG_ROWS * CG_G * (CG_QKV / 8);
         i += blockDim.x) {
      const int rg = i / (CG_QKV / 8), c = (i - rg * (CG_QKV / 8)) * 8;
      const int r = rg / CG_G, grp = rg - r * CG_G;
      const bf16* src = (c < CG_CPERG ? q : c < 2 * CG_CPERG ? k : v) +
                        r * CG_LDQ + CG_CPERG * grp + c % CG_CPERG;
      *reinterpret_cast<uint4*>(pq + (size_t)rg * CB_OPQ + CG_CPG + c) =
          *reinterpret_cast<const uint4*>(src);
    }
    for (int u = warp; u < 4 * CG_G; u += NTHREADS / 32) {
      const int mt = u / CG_G, grp = u - mt * CG_G;
      float acc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      bf16* const dsrc[3] = {q, k, v};
#pragma unroll
      for (int w = 0; w < 3; ++w) {
        unsigned af[4];
        load_a(af, dsrc[w] + 16 * mt * CG_LDQ + CG_CPERG * grp, CG_LDQ, lane);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          unsigned bf[4];
          load_b_kn(bf, wqkvt + 16 * w * CB_LDT + 16 * np, CB_LDT, lane);
          mma_bf16_16816(acc[2 * np], af, bf);
          mma_bf16_16816(acc[2 * np + 1], af, bf + 2);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          store_bf16x2(dO + (16 * mt + g + 8 * hf) * CG_LDX + CG_CPG * grp +
                           8 * j + 2 * t,
                       pack_bf16x2(acc[j][2 * hf], acc[j][2 * hf + 1]));
    }
    __syncthreads();
    store_dxn();
    __syncthreads();
    QV_STAMP(cga_bwd, 5);
  }
  // ---- the bank: the warps' sums in order, then its gradients, each
  // element stored once -------------------------------------------------
  float* red = reinterpret_cast<float*>(q);        // [8][2][16][16]
  float* dkb = red + 8 * 2 * 256;                  // [2][16][16] sums
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = (g + 8 * (e >> 1)) * CG_CPERG + 8 * j + 2 * t + (e & 1);
      red[(warp * 2) * 256 + i] = gkb[j][e];
      red[(warp * 2 + 1) * 256 + i] = gvb[j][e];
    }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * 256; i += blockDim.x) {
    const int w = i >> 8, e = i & 255;
    float sum = 0.f;
    for (int wp = 0; wp < NTHREADS / 32; ++wp) sum += red[(wp * 2 + w) * 256 + e];
    dkb[i] = zero_attn ? 0.f : sum;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * CG_C * CG_CPERG; i += blockDim.x) {
    // the projections' kernels: bank^T @ sum, [C, 16] each
    const int w = i / (CG_C * CG_CPERG), e = i - w * CG_C * CG_CPERG;
    const int kk = e / CG_CPERG, j = e - kk * CG_CPERG;
    const float* br = (w ? a.c.bank_vr : a.c.bank_kr) + kk;
    const float* dsum = dkb + w * 256 + j;
    float acc = 0.f;
    for (int mm = 0; mm < S; ++mm)
      acc = fmaf(br[mm * C], dsum[mm * CG_CPERG], acc);
    slice(w ? gr.bv_w : gr.bk_w, a.c)[e] = zero_attn ? 0.f : acc;
  }
  for (int i = threadIdx.x; i < 2 * CG_CPERG; i += blockDim.x) {
    const int w = i / CG_CPERG, j = i - w * CG_CPERG;
    float acc = 0.f;
    for (int mm = 0; mm < S; ++mm) acc += dkb[w * 256 + mm * CG_CPERG + j];
    slice(w ? gr.bv_b : gr.bk_b, a.c)[j] = acc;
  }
  for (int i = threadIdx.x; i < 2 * S * CG_C; i += blockDim.x) {
    // the bank rows: sum @ rnd(W)^T, [S, C] each
    const int w = i / (S * CG_C), e = i - w * S * CG_C;
    const int mm = e / CG_C, kk = e - mm * CG_C;
    const float* W = (w ? f.bv_w : f.bk_w) + kk * CG_CPERG;
    const float* dsum = dkb + w * 256 + mm * CG_CPERG;
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < CG_CPERG; ++j)
      acc = fmaf(dsum[j], rnd<bf16>(W[j]), acc);
    slice(w ? gr.bank_v : gr.bank_k, a.c)[e] = zero_attn ? 0.f : acc;
  }
  __syncthreads();
  QV_STAMP(cga_bwd, 6);
  // ---- the weight gradients over every row of the block, each stored
  // once into the slice (zeros for the guarded branch's q, k, v) ---------
  bf16* stage = reinterpret_cast<bf16*>(qv_smem);
  wgrad_block(opp, opp + CG_GW, CB_OPP, CG_ROWS * passes, CG_GW, C,
              slice(gr.proj_w, a.c), C, slice(gr.proj_b, a.c), stage,
              CB_SMEM_BYTES / 2);
  for (int w = 0; w < 3; ++w) {
    // q, k or v's slice fields by selects (an array indexed by w would go
    // to the stack)
    float* gw = slice(w == 0 ? gr.q_w : w == 1 ? gr.k_w : gr.v_w, a.c);
    float* gb = slice(w == 0 ? gr.q_b : w == 1 ? gr.k_b : gr.v_b, a.c);
    if (zero_attn) {
      for (int i = threadIdx.x; i < CG_CPG * CG_CPERG; i += blockDim.x)
        gw[i] = 0.f;
      for (int i = threadIdx.x; i < CG_CPERG; i += blockDim.x) gb[i] = 0.f;
    } else {
      wgrad_block(opq, opq + CG_CPG + CG_CPERG * w, CB_OPQ,
                  CG_ROWS * CG_G * passes, CG_CPG, CG_CPERG, gw, CG_CPERG,
                  gb, stage, CB_SMEM_BYTES / 2);
    }
  }
  QV_STAMP(cga_bwd, 7);
}


// n = 64, per cluster: each CTA's operand rows (bf16), rows_max rows of
// proj's and 3 x rows_max of the q/k/v kernel's (rows_max: 64 a sample of
// the cluster's most)
__host__ __device__ inline int cga_bwd_mma64_scratch_floats(const Dims& d) {
  const int nb = (d.B + d.grid - 1) / d.grid;
  return 2 * nb * CG_ROWS * (C6_OPP + C6_G * CB_OPQ) / 2;
}

// n = 64: a cluster of two CTAs walks its samples b = c, c + clusters, ...
// (c = blockIdx.x / 2), a pass a sample, CTA rank h its channel groups
// 3h..3h+2: their xn columns, q, k, v, the attention and att columns, the
// same d(out) whole in both (d(att) = d(out) W_p^T needs every column),
// 12 (group, head) units of the recompute and the attention backward
// over the 8 warps (cga_head_fwd64, cga_head_bwd64; warp w has head w % 4
// in both its units).  The buffers of a pass: the warps' space (xs, the
// CTA's 96 xn columns, and dO [64, C], d(out) through the proj dropout;
// then each warp's P, then dS; then d(xn)'s 96 columns in xs's place); q,
// k, v [64, 48], then d(q), d(k), d(v); att, then d(att); each warp's dK
// and dV sums.  At the end each
// CTA forms proj's weight gradient rows of its att columns (rank 0 the
// bias too) over its rows, and its own sums of the shared weights'
// gradients (the q | k | v kernels over its (row, group) operand rows, the
// bank keys' and values' cotangents); the pair sums those in rank order
// through distributed shared memory into the cluster's slice, rank 0 the
// bank keys' projection and rows, rank 1 the values'.  Every field of the
// slice stored once.
__global__ void __launch_bounds__(NTHREADS, 2)
    cga_bwd_mma64_kernel(CgaBwdMmaArgs m) {
  constexpr int SN = CG_ROWS;              // rows of a sample
  QV_SMEM_DECL
  QV_STAMP(cga_bwd, -1);
  const CgaBwdArgs& a = m.a;
  const CgaArgs& f = a.f;
  const Dims& d = f.d;
  const CgaGrads& gr = a.g;
  const int S = d.bank_s, C = CG_C;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int rank = (int)cluster_rank();
  const int unit = (int)blockIdx.x / 2, units = (int)gridDim.x / 2;
  const int g0 = C6_G * rank;                      // the CTA's first group
  auto sl = [&](float* p) { return p + (size_t)unit * a.c.wstride; };
  bf16* wqkv = reinterpret_cast<bf16*>(qv_smem);   // [32][CG_LDW]
  bf16* wpt = wqkv + CG_CPG * CG_LDW;              // [192][C6_LDPT]
  bf16* kbp = wpt + CG_C * C6_LDPT;                // [16][CG_LDB]
  bf16* vbp = kbp + CG_S * CG_LDB;
  bf16* wsp = vbp + CG_S * CG_LDB;                 // [C6_WS]
  bf16* xs = wsp;                                  // [64][C6_LDXS]
  bf16* dO = xs + CG_ROWS * C6_LDXS;               // [64][CG_LDX]
  bf16* q = wsp + C6_WS;                           // [64][C6_LDQ] each
  bf16* k = q + C6_QB;
  bf16* v = k + C6_QB;
  bf16* att = v + C6_QB;
  bf16* wsc = wsp + warp * NT * CB_LDT64;          // this warp's P, dS
  float* sums = reinterpret_cast<float*>(att + C6_QB) + warp * C6_SUMS;
  const bool zero_attn = d.guard && a.c.flag[1] != 0;
  const int nb = (d.B - unit + units - 1) / units;  // the cluster's samples
  const int rows_max = ((d.B + d.grid - 1) / d.grid) * CG_ROWS;
  float* scr = a.c.scratch + (size_t)unit * cga_bwd_mma64_scratch_floats(d);
  bf16* opp = reinterpret_cast<bf16*>(scr) +
              (size_t)rank * rows_max * (C6_OPP + C6_G * CB_OPQ);
  bf16* opq = opp + (size_t)rows_max * C6_OPP;

  // per CTA: the kernels, proj^T's rows of its att columns (cp.async; the
  // first pass's wait completes them) and the projected bank
  stage_weight(wqkv, CG_LDW, m.w + CB_QKV, CG_CPG, CG_QKV);
  for (int i = threadIdx.x; i < CG_C * (C6_GW / 8); i += NTHREADS) {
    const int r = i / (C6_GW / 8), c = (i - r * (C6_GW / 8)) * 8;
    cp_async_16(wpt + r * C6_LDPT + c,
                m.w + CB_PROJT + (size_t)r * CG_GW + C6_GW * rank + c);
  }
  cp_async_commit();
  cga_bank_proj(f, kbp, vbp);
  // this warp's sums of the bank keys' and values' cotangents over its
  // units, all of head warp % 4 (units u = warp, warp + 8), zeroed: keys
  // g, g + 8 x channels 8j + 2t, 8j + 2t + 1 of a group's 16, j = head / 2
  static_assert((NTHREADS / 32) % CG_H == 0, "a warp's units one head");
  const bool hl = head_lane(warp % CG_H);
  if (hl)
    for (int w = 0; w < 2; ++w)
      *reinterpret_cast<float4*>(c6_sum(sums, w, CB_NKT64 - 1, g, t)) =
          float4{0.f, 0.f, 0.f, 0.f};
  QV_STAMP(cga_bwd, 0);

  for (int p = 0; p < nb; ++p) {
    const int b = unit + p * units;
    auto tok = [&](int r) { return b * SN + r; };
    for (int i = threadIdx.x; i < CG_ROWS * (C6_XW / 8); i += NTHREADS) {
      const int r = i / (C6_XW / 8), c = (i - r * (C6_XW / 8)) * 8;
      cp_async_16(xs + r * C6_LDXS + c, static_cast<const bf16*>(f.xn) +
                                            (size_t)tok(r) * C + C6_XW * rank +
                                            c);
    }
    for (int i = threadIdx.x; i < CG_ROWS * (C / 8); i += NTHREADS) {
      const int r = i / (C / 8), c = (i - r * (C / 8)) * 8;
      cp_async_16(dO + r * CG_LDX + c,
                  static_cast<const bf16*>(a.d_out) + (size_t)tok(r) * C + c);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    QV_STAMP(cga_bwd, 1);
    // d(out) through the proj dropout
    if (d.train && d.drop_on)
      for (int i = threadIdx.x; i < CG_ROWS * C; i += NTHREADS) {
        const int r = i / C, c = i - r * C;
        bf16* e = dO + r * CG_LDX + c;
        *e = from_f<bf16>(drop(d, CGA_PROJ, (unsigned)(tok(r) * C + c),
                               to_f<bf16>(*e)));
      }
    bf16* pp = opp + (size_t)p * CG_ROWS * C6_OPP;
    bf16* pq = opq + (size_t)p * CG_ROWS * C6_G * CB_OPQ;
    // the CTA's 96 columns of d(xn) from `src` (null: zeros)
    auto store_dxn = [&](const bf16* src) {
      for (int i = threadIdx.x; i < CG_ROWS * (C6_XW / 8); i += NTHREADS) {
        const int r = i / (C6_XW / 8), c = (i - r * (C6_XW / 8)) * 8;
        *reinterpret_cast<uint4*>(static_cast<bf16*>(a.d_xn) +
                                  (size_t)tok(r) * C + C6_XW * rank + c) =
            src ? *reinterpret_cast<const uint4*>(src + r * C6_LDXS + c)
                : uint4{0u, 0u, 0u, 0u};
      }
    };
    if (zero_attn) {
      // a guarded branch: no gradient passes through its attention, so
      // only proj's bias learns (its input is zero), and d(xn) is zero
      for (int i = threadIdx.x; i < C6_QB; i += NTHREADS)
        att[i] = from_f<bf16>(0.f);
      __syncthreads();
      save_rows(pp, C6_OPP, att, C6_LDQ, C6_GW, CG_ROWS);
      save_rows(pp + C6_GW, C6_OPP, dO, CG_LDX, C, CG_ROWS);
      store_dxn(nullptr);
      __syncthreads();
      continue;
    }
    // ---- recompute: q | k | v of the CTA's groups, unit (16 rows, group)
    for (int u = warp; u < 4 * C6_G; u += NTHREADS / 32) {
      const int mt = u / C6_G, gl = u - mt * C6_G;
      float acc[6][4];
#pragma unroll
      for (int j = 0; j < 6; ++j)
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < CG_CPG / 16; ++ks) {
        unsigned af[4];
        load_a(af, xs + 16 * mt * C6_LDXS + CG_CPG * gl + 16 * ks, C6_LDXS,
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
        const float* bias = w == 0 ? f.q_b : w == 1 ? f.k_b : f.v_b;
        bf16* dst = w == 0 ? q : w == 1 ? k : v;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          store_bf16x2(dst + (16 * mt + g + 8 * hf) * C6_LDQ + CG_CPERG * gl +
                           c,
                       pack_bf16x2(dense_out(acc[j][2 * hf], bias[c]),
                                   dense_out(acc[j][2 * hf + 1], bias[c + 1])));
      }
    }
    __syncthreads();
    // ---- the attention, unit (group, head) -----------------------------
    for (int u = warp; u < C6_G * CG_H; u += NTHREADS / 32) {
      const int gl = u / CG_H, h = u - gl * CG_H, c0 = CG_CPERG * gl;
      const AttnMask am{attn_drop(d, CGA_ATTN),
                        (unsigned)(b * CG_G * CG_H * SN) * (SN + S),
                        (g0 + gl) * CG_H + h, SN + S, SN};
      cga_head_fwd64(q + c0, k + c0, v + c0, C6_LDQ, kbp, vbp, SN + S, am,
                     h, att + c0);
    }
    __syncthreads();
    QV_STAMP(cga_bwd, 2);
    // ---- proj: its operand rows, the q | k | v kernel's input columns
    // (row, group), then d(att) = d(out) @ W_p^T over att ------------------
    save_rows(pp, C6_OPP, att, C6_LDQ, C6_GW, CG_ROWS);
    save_rows(pp + C6_GW, C6_OPP, dO, CG_LDX, C, CG_ROWS);
    for (int i = threadIdx.x; i < CG_ROWS * C6_G * (CG_CPG / 8);
         i += NTHREADS) {
      const int rg = i / (CG_CPG / 8), c = (i - rg * (CG_CPG / 8)) * 8;
      const int r = rg / C6_G, gl = rg - r * C6_G;
      *reinterpret_cast<uint4*>(pq + (size_t)rg * CB_OPQ + c) =
          *reinterpret_cast<const uint4*>(xs + r * C6_LDXS + CG_CPG * gl + c);
    }
    __syncthreads();
    {  // warp w: rows 16 (w % 4).., columns 0..31 (w < 4) or 32..47
      const int mt = warp & 3, n0 = warp < 4 ? 0 : 32;
      const int npn = warp < 4 ? 2 : 1;
      float acc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll 4
      for (int ks = 0; ks < C / 16; ++ks) {
        unsigned af[4];
        load_a(af, dO + 16 * mt * CG_LDX + 16 * ks, CG_LDX, lane);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          if (np >= npn) break;
          unsigned bf[4];
          load_b_kn(bf, wpt + 16 * ks * C6_LDPT + n0 + 16 * np, C6_LDPT,
                    lane);
          mma_bf16_16816(acc[2 * np], af, bf);
          mma_bf16_16816(acc[2 * np + 1], af, bf + 2);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j >= 2 * npn) break;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          store_bf16x2(att + (16 * mt + g + 8 * hf) * C6_LDQ + n0 + 8 * j +
                           2 * t,
                       pack_bf16x2(acc[j][2 * hf], acc[j][2 * hf + 1]));
      }
    }
    __syncthreads();
    QV_STAMP(cga_bwd, 3);
    // ---- the attention backward, unit (group, head): d(q), d(k), d(v)
    // over q, k, v; the bank's sums ----------------------------------------
    for (int u = warp; u < C6_G * CG_H; u += NTHREADS / 32) {
      const int gl = u / CG_H, h = u - gl * CG_H, c0 = CG_CPERG * gl;
      const AttnMask am{attn_drop(d, CGA_ATTN),
                        (unsigned)(b * CG_G * CG_H * SN) * (SN + S),
                        (g0 + gl) * CG_H + h, SN + S, SN};
      cga_head_bwd64(q + c0, k + c0, v + c0, att + c0, C6_LDQ, kbp, vbp,
                     SN + S, am, h, wsc, sums);
    }
    __syncthreads();
    QV_STAMP(cga_bwd, 4);
    // ---- the q | k | v kernel: its operand rows' cotangent columns (row,
    // group), then d(xn) = d(q | k | v) @ W_qkv^T per group into xs's
    // place --------------------------------------------------------------
    for (int i = threadIdx.x; i < CG_ROWS * C6_G * (CG_QKV / 8);
         i += NTHREADS) {
      const int rg = i / (CG_QKV / 8), c = (i - rg * (CG_QKV / 8)) * 8;
      const int r = rg / C6_G, gl = rg - r * C6_G;
      const bf16* src = (c < CG_CPERG ? q : c < 2 * CG_CPERG ? k : v) +
                        r * C6_LDQ + CG_CPERG * gl + c % CG_CPERG;
      *reinterpret_cast<uint4*>(pq + (size_t)rg * CB_OPQ + CG_CPG + c) =
          *reinterpret_cast<const uint4*>(src);
    }
    for (int u = warp; u < 4 * C6_G; u += NTHREADS / 32) {
      const int mt = u / C6_G, gl = u - mt * C6_G;
      float acc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
      for (int w = 0; w < 3; ++w) {
        unsigned af[4];
        load_a(af, (w == 0 ? q : w == 1 ? k : v) + 16 * mt * C6_LDQ +
                       CG_CPERG * gl,
               C6_LDQ, lane);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          unsigned bf[4];
          // W_qkv^T's [48, 32] tile from W_qkv [32, 48] as it is
          load_b_nk(bf, wqkv + 16 * np * CG_LDW + 16 * w, CG_LDW, lane);
          mma_bf16_16816(acc[2 * np], af, bf);
          mma_bf16_16816(acc[2 * np + 1], af, bf + 2);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          store_bf16x2(xs + (16 * mt + g + 8 * hf) * C6_LDXS + CG_CPG * gl +
                           8 * j + 2 * t,
                       pack_bf16x2(acc[j][2 * hf], acc[j][2 * hf + 1]));
    }
    __syncthreads();
    store_dxn(xs);
    __syncthreads();
    QV_STAMP(cga_bwd, 5);
  }
  // ---- the bank: the warps' sums in order into the CTA's ---------------
  float* red = reinterpret_cast<float*>(q);        // [8][2][256]
  float* dkb = red + C6_DKB;                       // [2][256]
  float* pqw = red + C6_PQ;                        // q | k | v kernels
  float* tot = red + C6_TOT;                       // the pair's [256]
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = (g + 8 * (e >> 1)) * CG_CPERG + 8 * j + 2 * t + (e & 1);
      const bool mine = j == (warp % CG_H) >> 1 && hl;
      red[(warp * 2) * 256 + i] =
          mine ? c6_sum(sums, 0, CB_NKT64 - 1, g, t)[e] : 0.f;
      red[(warp * 2 + 1) * 256 + i] =
          mine ? c6_sum(sums, 1, CB_NKT64 - 1, g, t)[e] : 0.f;
    }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * 256; i += NTHREADS) {
    const int w = i >> 8, e = i & 255;
    float sum = 0.f;
    for (int wp = 0; wp < NTHREADS / 32; ++wp)
      sum += red[(wp * 2 + w) * 256 + e];
    dkb[i] = zero_attn ? 0.f : sum;
  }
  __syncthreads();
  QV_STAMP(cga_bwd, 6);
  // ---- proj's weight gradient rows of the CTA's att columns over its
  // rows (rank 0 the bias), stored into the slice; the q | k | v kernels'
  // over its (row, group) rows into pqw (zeros for the guarded branch) ----
  bf16* stage = reinterpret_cast<bf16*>(qv_smem);  // up to q's space
  const int elems = static_cast<int>(q - stage);
  wgrad_block(opp, opp + C6_GW, C6_OPP, CG_ROWS * nb, C6_GW, C,
              sl(gr.proj_w) + C6_GW * rank * C, C,
              rank ? nullptr : sl(gr.proj_b), stage, elems);
  if (zero_attn) {
    for (int i = threadIdx.x; i < C6_NPQ; i += NTHREADS) pqw[i] = 0.f;
  } else {
    for (int w = 0; w < 3; ++w)
      wgrad_block(opq, opq + CG_CPG + CG_CPERG * w, CB_OPQ,
                  CG_ROWS * C6_G * nb, CG_CPG, CG_CPERG,
                  pqw + w * CG_CPG * CG_CPERG, CG_CPERG,
                  pqw + 3 * CG_CPG * CG_CPERG + CG_CPERG * w, stage, elems);
  }
  __syncthreads();
  cluster_sync();          // the partner's sums are in its shared memory
  // ---- the pair's sums in rank order: rank 0 the bank keys' gradients,
  // rank 1 the values'; the q | k | v kernels' half the elements each ---
  const float* dkb0 = rank ? cluster_peer(dkb, 0u) : dkb;
  const float* dkb1 = rank ? dkb : cluster_peer(dkb, 1u);
  for (int i = threadIdx.x; i < 256; i += NTHREADS)
    tot[i] = dkb0[rank * 256 + i] + dkb1[rank * 256 + i];
  const float* pq0 = rank ? cluster_peer(pqw, 0u) : pqw;
  const float* pq1 = rank ? pqw : cluster_peer(pqw, 1u);
  for (int i = threadIdx.x + rank * NTHREADS; i < C6_NPQ;
       i += 2 * NTHREADS) {
    const int n = CG_CPG * CG_CPERG;
    const int w = i < 3 * n ? i / n : (i - 3 * n) / CG_CPERG;
    const int e = i < 3 * n ? i - w * n : i - 3 * n - w * CG_CPERG;
    float* field = i < 3 * n ? (w == 0 ? gr.q_w : w == 1 ? gr.k_w : gr.v_w)
                             : (w == 0 ? gr.q_b : w == 1 ? gr.k_b : gr.v_b);
    sl(field)[e] = pq0[i] + pq1[i];
  }
  __syncthreads();
  const float* br = rank ? a.c.bank_vr : a.c.bank_kr;
  for (int i = threadIdx.x; i < CG_C * CG_CPERG; i += NTHREADS) {
    // the projection's kernel: bank^T @ sum, [C, 16]
    const int kk = i / CG_CPERG, j = i - kk * CG_CPERG;
    float acc = 0.f;
    for (int mm = 0; mm < S; ++mm)
      acc = fmaf(br[mm * C + kk], tot[mm * CG_CPERG + j], acc);
    sl(rank ? gr.bv_w : gr.bk_w)[i] = zero_attn ? 0.f : acc;
  }
  for (int j = threadIdx.x; j < CG_CPERG; j += NTHREADS) {
    float acc = 0.f;
    for (int mm = 0; mm < S; ++mm) acc += tot[mm * CG_CPERG + j];
    sl(rank ? gr.bv_b : gr.bk_b)[j] = acc;
  }
  for (int i = threadIdx.x; i < S * CG_C; i += NTHREADS) {
    // the bank rows: sum @ rnd(W)^T, [S, C]
    const int mm = i / CG_C, kk = i - mm * CG_C;
    const float* W = (rank ? f.bv_w : f.bk_w) + kk * CG_CPERG;
    const float* dsum = tot + mm * CG_CPERG;
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < CG_CPERG; ++j)
      acc = fmaf(dsum[j], rnd<bf16>(W[j]), acc);
    sl(rank ? gr.bank_v : gr.bank_k)[i] = zero_attn ? 0.f : acc;
  }
  cluster_sync();          // the partner has read this CTA's sums
  QV_STAMP(cga_bwd, 7);
}

}  // namespace qv

// bf16 at hqavit_c100's widths: `a` as for qv_unit_cga_bwd with a
// per-block scratch of cga_bwd_mma_scratch_floats(d), the bf16 weights
// beside it (CgaBwdMmaArgs); the workspace `gws` may hold anything (the
// kernel stores every field).  ERR_ARGS for any other geometry or type
// (the wrapper checks them first, cga_bwd_mma_error).
extern "C" int qv_unit_cga_bwd_mma(const qv::CgaBwdArgs* a, const void* w,
                                   int is_bf16, void* stream) {
  const qv::Dims& d = a->f.d;
  if (!is_bf16 || d.n != qv::NT || d.nw != 1 ||
      d.c != qv::CG_C || d.groups != qv::CG_G || d.cperg != qv::CG_CPERG ||
      d.heads != qv::CG_H || d.bank_s > qv::CG_S || d.grid > d.B)
    return qv::ERR_ARGS;
  const qv::CgaBwdMmaArgs m{*a, static_cast<const qv::bf16*>(w)};
  const int rc = qv_launch(qv::cga_bwd_mma_kernel, m, qv::CB_SMEM_BYTES,
                           stream, d.grid);
  if (rc != 0) return rc;
  return qv_reduce(a->c.gws, a->c.grad, d.grid, a->c.wstride, d.rgrid, stream);
}

// bf16 at hqavit_tiny_in's widths, n = 64 (cga_bwd_mma64_kernel): d.grid
// clusters of two CTAs, one gradient slice each in `gws` (which may hold
// anything: the kernel stores every field), a scratch of
// cga_bwd_mma64_scratch_floats(d) a cluster.  A cluster launch the card
// refuses returns its CUDA error.
extern "C" int qv_unit_cga_bwd_mma64(const qv::CgaBwdArgs* a, const void* w,
                                     int is_bf16, void* stream) {
  const qv::Dims& d = a->f.d;
  if (!is_bf16 || d.n != qv::CG_ROWS || d.nw != 4 ||
      d.side != 8 || d.c != qv::CG_C || d.groups != qv::CG_G ||
      d.cperg != qv::CG_CPERG || d.heads != qv::CG_H ||
      d.bank_s > qv::CG_S || d.grid > d.B)
    return qv::ERR_ARGS;
  const qv::CgaBwdMmaArgs m{*a, static_cast<const qv::bf16*>(w)};
  const int rc = qv_launch_cluster(qv::cga_bwd_mma64_kernel, m,
                                   qv::C6_SMEM_BYTES, stream, d.grid, 2);
  if (rc != 0) return rc;
  return qv_reduce(a->c.gws, a->c.grad, d.grid, a->c.wstride, d.rgrid, stream);
}

extern "C" int qv_unit_cga_bwd_mma64_smem(const qv::Dims*) {
  return qv::C6_SMEM_BYTES;
}

extern "C" int qv_unit_cga_bwd_mma64_scratch(const qv::Dims* d) {
  return qv::cga_bwd_mma64_scratch_floats(*d);
}

extern "C" int qv_unit_cga_bwd_mma_smem(const qv::Dims*) {
  return qv::CB_SMEM_BYTES;
}

extern "C" int qv_unit_cga_bwd_mma_scratch(const qv::Dims* d) {
  return qv::cga_bwd_mma_scratch_floats(*d);
}

// CTAs of cga_bwd_mma64_kernel resident per SM and its two-CTA clusters
// resident at once on the card (0 on the host)
extern "C" int qv_unit_cga_bwd_mma64_occupancy(int* per_sm, int* clusters) {
  return qv_cluster_occupancy(qv::cga_bwd_mma64_kernel, qv::C6_SMEM_BYTES, 2,
                              per_sm, clusters);
}
