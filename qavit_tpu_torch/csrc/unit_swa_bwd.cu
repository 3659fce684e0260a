// Unit 1 of the fused block, backward: the VJP of norm1 + SWA branch.
//
// Replaces the TPU kernel qavit_tpu/kernels/fused_pallas.py:244 bwd_call
// (pallas_call at :245, bwd_kernel :219-242) for the core `swa`
// (fused_kernels.py:75): recompute the unit in-kernel, take its VJP,
// accumulate the weight gradients over the batch in float32.
//
// Bound on the H100 at B=1024 (bf16): it reads x and the two cotangents
// and writes d(x) (4 x 6.3 MB, ~7.5 us) against ~2 x 5.9 GFLOP of
// recompute plus ~2 x 5.9 GFLOP of gradient products (~24 us at 989
// TFLOP/s): the operations bound it.
//
// float32, swa_bwd_kernel: the first design, on the CUDA cores (TF32
// keeps too few digits for the 1e-4 gradient tolerance).  Per sample the
// forward is recomputed through swa_body (unit_swa.cuh), the same code
// as the forward kernel, with the forward's masks replayed from the hash
// and the forward's NaN-guard flag (a guarded branch passes zero
// gradient to q, k and v).  Then proj, attention (dropout, softmax), the
// Linformer token mix, the qkv Dense and norm1 are differentiated in
// shared memory.  d(x) is written per sample in the working type; the
// weight and bank gradients are added to this block's float32 slice of
// the workspace, and the reduction pass sums the slices in block order.
// One 256-thread block per SM walks its share of the samples with ~221
// KB of shared memory; latency-bound.
//
// bf16 at hqavit_c100's widths, swa_bwd_mma_kernel: msda_bwd_mma_kernel's
// design (unit_msda_bwd.cu) with the window's own 16 tokens where MSDA
// has its pooled rows, and norm1 in front.  Every product on the tensor
// cores (mma.sync m16n8k16, bf16 operands, float32 sums) over a pass of
// two samples (32 rows), every activation and cotangent as bf16 in shared
// memory (224 KB), the pieces in mma_ops.cuh.  Per pass: xn = norm1(x) by
// eight lanes a row; q, k, v through the weight ring; kc | vc = rnd(E^T
// @ k | v) per sample; the attention of 16 queries x one head a warp
// with the dropout replayed (warp_attention_train); then proj's d(att) =
// dO @ W_p^T; warp_attention_bwd (dq, dS, P) and each warp's own d(kc),
// d(vc) = dS^T q, P^T dO; the bank keys' gradients summed over the pass;
// the Linformer backward (d(E) = k @ d(kc)^T, d(k) = E @ d(kc)); d(xn) =
// d(qkv) @ W_qkv^T + the cotangent of xn in one product over K = 3C;
// norm1's backward (ln_bwd_rows).  The dgrads read transposed bf16
// weights, which the wrapper makes once per call beside the forward's.
// Each pass saves the dense layers' operand rows to a per-block scratch,
// and at the end the block forms the qkv and proj weight gradients over
// all its rows (wgrad_block).  The block keeps the other sums across its
// passes (E's and the bank rows' in registers, norm1's scale and bias in
// shared memory) and stores every field of its slice once, without
// reading it, so the caller's workspace needs no zeroing.  Time: PERF.md
// section 6 row 5.
//
// bf16 at hqavit_tiny_in's widths, n = 64 in four 4x4 windows on an 8x8
// grid, swa_bwd_mma_kernel<4>: the windows are independent but for
// norm1's and the weights' sums, and the bank partials lie outside
// autograd, so the same body walks the B x 4 windows as the n = 16 one
// walks samples, a window's rows gathered from the grid and its d(x)
// scattered back (the masks are the [B nw, 16, ...] layouts' own), on
// thread-block clusters of two CTAs, as many as the SMs hold (the grid
// counts windows: 66 clusters on 132 SMs at B=128).  Its block 0 spent
// 0.063 of 0.200 ms at B=128, and 1.23 of 2.23 ms at B=1024, forming the
// weight gradients (wgrad_block: a store and a read-back of the slice per
// chunk of rows, one dependent chain a warp), so the pair shares the
// tail: each CTA forms half the columns of each weight gradient over both
// CTAs' rows with the sums in registers (wgrad_stream), the other sums
// meet through distributed shared memory, and one slice a cluster is
// stored (half the bytes written and reduced).  The dropout scales and the
// softmax's row sums are products with reciprocals (within an ulp of the
// quotients: the IEEE divisions were a large part of the attention
// phases), each warp keeps its probabilities in registers from the
// attention to its backward (no second softmax), and the cotangent of xn
// is staged in shared memory.  Left as they were: the passes' products,
// bound inside the SM (neither prefetching each product's first slices,
// nor five 32-row slices in the ring, nor two of 64 rows moved them;
// PERF.md).
// Bound at B=128 on the H100: 13.8 MB against 8.8 GFLOP (~8.9 us): the
// operations bound it.  Time: PERF.md section 6 row 5 @n64.
#include "cluster.cuh"
#include "mma_ops.cuh"
#include "unit_swa.cuh"

namespace qv {

__host__ __device__ inline int swa_bwd_smem_floats(const Dims& d) {
  const int c = d.c, lk = d.lin_k;
  const int kvn = pad4(d.heads * NT * (lk + d.bank_s));
  return NT * c           // A: x, then d(att), then x again
         + NT * c         // xn
         + 3 * NT * c     // qkv, then d(qkv)
         + 2 * lk * c     // kc, vc
         + NT * c         // att, then d(x)
         + NT * c         // O: out, then d(out), then d(xn)
         + 2 * lk * c     // d(kc), d(vc)
         + 3 * kvn        // P, PV probabilities, d(scores)
         + 4 * NT;        // LN stats
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS, 1) swa_bwd_kernel(SwaBwdArgs a) {
  QV_SMEM_DECL
  __shared__ int bad;
  const SwaArgs& f = a.f;
  const Dims& d = f.d;
  const int c = d.c, lk = d.lin_k, S = d.bank_s, h = d.heads;
  const int kvn = pad4(h * NT * (lk + S));
  float* A = qv_smem;
  float* xn = A + NT * c;
  float* qkv = xn + NT * c;
  float* kc = qkv + 3 * NT * c;
  float* vc = kc + lk * c;
  float* att = vc + lk * c;
  float* O = att + NT * c;
  float* dkc = O + NT * c;
  float* dvc = dkc + lk * c;
  float* sc = dvc + lk * c;
  float* pr = sc + kvn;
  float* dp = pr + kvn;
  float* stats = dp + kvn;
  const SwaBufs s{A, xn, qkv, kc, vc, a.c.bank_kr, a.c.bank_vr, sc, pr, att, O,
                  stats};
  const SwaGrads& g = a.g;
  const bool zero_attn = d.guard && a.c.flag[1] != 0;
  float* g_bank_k = slice(g.bank_k, a.c);
  float* g_bank_v = slice(g.bank_v, a.c);

  for (int b = blockIdx.x; b < d.B; b += gridDim.x) {
    const size_t off = (size_t)b * NT * c;
    swa_body<T>(f, b, zero_attn, s, &bad);
    // proj dropout and proj
    load_tile<T>(O, static_cast<const T*>(a.d_out) + off, NT * c);
    __syncthreads();
    drop_rows(d, SWA_PROJ, (unsigned)(b * NT * c), O, NT * c);
    __syncthreads();
    dense_wgrad(att, c, 0, NT, c, O, c, c, 1, slice(g.proj_w, a.c), c,
                slice(g.proj_b, a.c));
    dense_dgrad<T>(O, c, NT, c, f.proj_w, c, c, 1, 0, A, c, false);
    __syncthreads();
    load_tile<T>(O, static_cast<const T*>(a.d_xn) + off, NT * c);
    // a guarded branch passes zero gradient through its attention, so
    // nothing before it gets any (and no NaN of the batch leaks into
    // the weight gradients as NaN * 0)
    if (!zero_attn) {
      // attention; d(q) lands in q's columns of qkv
      attention_bwd<T>(qkv, 3 * c, NT, h, c / h, kc, vc, c, lk, s.bk, s.bv, c,
                       S, h, A, c, sc, pr, dp, attn_drop(d, SWA_ATTN),
                       (unsigned)b * h * NT * (lk + S), qkv, 3 * c, dkc, dvc,
                       c, g_bank_k, g_bank_v, c);
      // Linformer token mix: d(E), then d(k), d(v) over k, v in qkv
      token_mix_bwd<T>(f.e_k, lk, NT, qkv + c, 3 * c, dkc, c, c, qkv + c,
                       3 * c, false, slice(g.e_k, a.c));
      token_mix_bwd<T>(f.e_v, lk, NT, qkv + 2 * c, 3 * c, dvc, c, c,
                       qkv + 2 * c, 3 * c, false, slice(g.e_v, a.c));
      // qkv Dense
      dense_wgrad(xn, c, 0, NT, c, qkv, 3 * c, 3 * c, 1, slice(g.qkv_w, a.c),
                  3 * c, slice(g.qkv_b, a.c));
      dense_dgrad<T>(qkv, 3 * c, NT, 3 * c, f.qkv_w, 3 * c, c, 1, 0, O, c,
                     true);
    }
    load_tile<T>(A, static_cast<const T*>(f.x) + off, NT * c);
    __syncthreads();
    // norm1
    layer_norm_bwd_rows(A, c, O, c, att, c, false, NT, c, f.norm1_s,
                        slice(g.norm1_s, a.c), slice(g.norm1_b, a.c), stats);
    store_tile<T>(static_cast<T*>(a.d_x) + off, att, NT * c);
    __syncthreads();
  }
}

}  // namespace qv

extern "C" int qv_unit_swa_bwd(const qv::SwaBwdArgs* a, int is_bf16,
                               void* stream) {
  const qv::Dims& d = a->f.d;
  const size_t smem = qv::swa_bwd_smem_floats(d) * sizeof(float);
  const int rc =
      is_bf16 ? qv_launch(qv::swa_bwd_kernel<qv::bf16>, *a, smem, stream,
                                     d.grid)
              : qv_launch(qv::swa_bwd_kernel<float>, *a, smem, stream,
                                     d.grid);
  if (rc != 0) return rc;
  return qv_reduce(a->c.gws, a->c.grad, d.grid, a->c.wstride, d.rgrid, stream);
}

extern "C" int qv_unit_swa_bwd_smem(const qv::Dims* d) {
  return qv::swa_bwd_smem_floats(*d) * (int)sizeof(float);
}

// --- bf16 at hqavit_c100's widths: the tensor-core kernel --------------------

QV_STAMPS_DEFINE(swa_bwd,
                 "prologue,stage,recompute,attention forward,proj,"
                 "attention backward and key gradients,Linformer backward,"
                 "d(xn) and norm1 backward,weight gradients,slice stores,"
                 "cluster barriers")

namespace qv {

struct SwaBwdMmaArgs {
  SwaBwdArgs a;           // the float32 kernel's arguments
  // bf16 [C, 3C] qkv | [C, C] proj | [3C, C] qkv^T | [C, C] proj^T
  const bf16* w;
};

// the geometry swa_bwd_mma_kernel is written for
// (fused_kernels.swa_bwd_mma_error)
constexpr int SB_C = 192, SB_H = 4, SB_LK = 32, SB_S = 16;
static_assert(SB_C / SB_H == ATT_D, "warp_attention's head width");
static_assert(SB_LK + SB_S == ATT_D, "a head's keys fill its dS columns");
constexpr int SB_QKV = 0, SB_PROJ = 3 * SB_C * SB_C;
constexpr int SB_QKVT = 4 * SB_C * SB_C, SB_PROJT = 7 * SB_C * SB_C;
// leading dims: 8 bf16 past the width (ldmatrix rows in distinct banks)
constexpr int SB_LDX = SB_C + 8, SB_LDQ = 3 * SB_C + 8;
constexpr int SB_LDE = NT + 8, SB_LDEN = SB_LK + 8;
constexpr int SB_X = PASS_ROWS * SB_LDX;       // one [32, C] buffer
// columns of a block's saved operand rows (save_rows; wgrad_block's
// inputs): proj's input and d(out); xn and d(qkv)
constexpr int SB_OP_ATT = 0, SB_OP_DO = SB_C, SB_OP_XN = 2 * SB_C;
constexpr int SB_OP_DQKV = 3 * SB_C, SB_OPW = 6 * SB_C;
constexpr int SB_RING = 3 * RING_KS * SB_LDX;  // three weight slices
constexpr int SB_BF16 = 2 * SB_S * SB_LDX      // bank k, v
                        + 2 * SB_LK * SB_LDE   // E_k^T, E_v^T
                        + 2 * NT * SB_LDEN     // E_k, E_v
                        + PASS_ROWS * SB_LDQ   // q | k | v, then d(qkv)
                        + 10 * SB_X + SB_RING;
// norm1's scale and bias gradients, then ln_bwd_rows' statistics
constexpr int SB_SMEM_BYTES = 2 * SB_BF16 + (2 * SB_C + 4 * PASS_ROWS) * 4;

// n = 64, the pair's sums in shared memory (floats, in pu's and the
// ring's place): the bank keys' gradients [2][SB_S][C], then d(E)
// [2][NT][SB_LK] from SB_OWN_E
constexpr int SB_OWN_E = 2 * SB_S * SB_C;
static_assert((SB_OWN_E + 2 * NT * SB_LK) * 4 <= (SB_X + SB_RING) * 2,
              "the pair's sums in pu and the ring");

// per block (n = 16) or cluster (n = 64): the operand rows (bf16) of its
// windows in passes of two
__host__ __device__ inline int swa_bwd_mma_scratch_floats(const Dims& d) {
  const int nb = (d.B * d.nw + d.grid - 1) / d.grid;
  return PASS_ROWS * ((nb + 1) / 2) * SB_OPW / 2;
}

// n = 16 (NW = 1): one block per SM walks its windows u = blockIdx.x,
// blockIdx.x + grid, ... in passes of two (an odd last pass runs a window
// of zeros with a zero cotangent, which adds nothing), its sums in its own
// slice.  n = 64 (NW = 4, PAIR): the B x 4 windows are independent but for
// norm1's and the weights' sums, so a thread-block cluster of two CTAs
// walks the windows u = c, c + clusters, ... (c = blockIdx.x / 2) in
// passes of two, pass p by CTA rank p % 2: a window's 16 rows gathered
// from the 8x8 grid and its cotangent scattered back
// (fused_ref.window_partition), its masks those of window u in the [B nw,
// 16, ...] layouts, as at n = 16 of sample u.  Both CTAs save their passes'
// operand rows to the cluster's scratch (pass p at row 32 p); after a
// cluster barrier each forms half the columns of each weight gradient over
// all of them (wgrad_stream), and the pair adds its other sums (the bank
// keys', d(E), norm1's) through distributed shared memory in rank order,
// half the elements each: one gradient slice a cluster, every field
// stored once.  The [32, C] buffers of a pass:
//   xs    x
//   kc    [sample][k, v] the compressed keys [32, C]; then d(kc), d(vc)
//   att   the attention rows; then d(att)
//   dO    d(out) through the proj dropout
//   dq    xn; then d(q); then d(xn)
//   ds    dS; then (n = 64) the cotangent of xn
//   pu    the probabilities PV used
// and qkv [32, 3C]: q | k | v, then d(q) | d(k) | d(v).  The operand rows
// of the weight gradients go to the scratch (SB_OP_*).
template <int NW>
__global__ void __launch_bounds__(NTHREADS, 1)
    swa_bwd_mma_kernel(SwaBwdMmaArgs m) {
  constexpr bool PAIR = NW != 1;           // a two-CTA cluster
  QV_SMEM_DECL
  QV_STAMP(swa_bwd, -1);
  const SwaBwdArgs& a = m.a;
  const SwaArgs& f = a.f;
  const Dims& d = f.d;
  const SwaGrads& gr = a.g;
  const int S = d.bank_s, C = SB_C, kvn = SB_LK + S;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  bf16* bk = reinterpret_cast<bf16*>(qv_smem);
  bf16* bv = bk + SB_S * SB_LDX;
  bf16* et = bv + SB_S * SB_LDX;         // [2][SB_LK][SB_LDE]
  bf16* en = et + 2 * SB_LK * SB_LDE;    // [2][NT][SB_LDEN]
  bf16* qkv = en + 2 * NT * SB_LDEN;
  bf16* xs = qkv + PASS_ROWS * SB_LDQ;
  bf16* kc = xs + SB_X;                  // [2][2][32][SB_LDX]
  bf16* att = kc + 4 * SB_X;
  bf16* dO = att + SB_X;
  bf16* dq = dO + SB_X;
  bf16* ds = dq + SB_X;
  bf16* pu = ds + SB_X;
  bf16* ring = pu + SB_X;
  float* gln = reinterpret_cast<float*>(ring + SB_RING);  // [2][C]
  float* stats = gln + 2 * C;                             // [32][4]
  const bf16 zero = from_f<bf16>(0.f);
  const bool zero_attn = d.guard && a.c.flag[1] != 0;
  auto kcv = [&](int s, int w) { return kc + (2 * s + w) * SB_X; };
  // the CTA's rank in its cluster; the slice's (and scratch's) index and
  // their count: the block's, or the cluster's
  int rank = 0;
  if constexpr (PAIR) rank = (int)cluster_rank();
  const int unit = PAIR ? (int)blockIdx.x / 2 : (int)blockIdx.x;
  const int units = PAIR ? (int)gridDim.x / 2 : (int)gridDim.x;
  auto sl = [&](float* p) { return p + (size_t)unit * a.c.wstride; };
  const float inv_keep = 1.f / d.keep;
  bf16* ops = reinterpret_cast<bf16*>(
      a.c.scratch + (size_t)unit * swa_bwd_mma_scratch_floats(d));

  // per block: the bank rows rounded (rows past S zero), E^T and E
  // rounded, norm1's gradient sums zeroed
  for (int i = threadIdx.x; i < SB_S * C; i += blockDim.x) {
    const int r = i / C, c = i - r * C;
    bk[r * SB_LDX + c] = from_f<bf16>(r < S ? rnd<bf16>(f.bank_k[i]) : 0.f);
    bv[r * SB_LDX + c] = from_f<bf16>(r < S ? rnd<bf16>(f.bank_v[i]) : 0.f);
  }
  for (int i = threadIdx.x; i < 2 * SB_LK * NT; i += blockDim.x) {
    const int w = i / (SB_LK * NT), r = i - w * SB_LK * NT;
    const int n = r / SB_LK, mr = r - n * SB_LK;
    const bf16 v = from_f<bf16>(rnd<bf16>((w ? f.e_v : f.e_k)[r]));
    et[(w * SB_LK + mr) * SB_LDE + n] = v;
    en[(w * NT + n) * SB_LDEN + mr] = v;
  }
  for (int i = threadIdx.x; i < 2 * C; i += blockDim.x) gln[i] = 0.f;
  // the sums this block keeps in registers over its passes: its bank
  // keys' gradients (warp: k or v, head), and d(E) (warps 0-3: k or v,
  // 16 of the 32 compressed rows)
  float gbank[3][2][4] = {};
  float ge[2][4] = {};
  QV_STAMP(swa_bwd, 0);

  // the token (row of the [B n, C] activations) of row i of window u
  auto row_of = [&](int u, int i) {
    if constexpr (NW == 1) return u * NT + i;
    const int b = u / NW, w = u - b * NW;
    return b * NW * NT + window_base(d, w) + (i / WS) * d.side + i % WS;
  };
  // rows of window slot s (< ns) from src, zeros past ns
  auto stage = [&](bf16* dst, const void* src, const int (&bs)[2], int ns) {
    for (int i = threadIdx.x; i < PASS_ROWS * (C / 8); i += blockDim.x) {
      const int r = i / (C / 8), c = (i - r * (C / 8)) * 8, s = r >> 4;
      bf16* to = dst + r * SB_LDX + c;
      if (s < ns)
        cp_async_16(to, static_cast<const bf16*>(src) +
                            (size_t)row_of(bs[s], r & 15) * C + c);
      else
        *reinterpret_cast<uint4*>(to) = uint4{0u, 0u, 0u, 0u};
    }
  };
  // the unit's windows unit + k units (k < nu), pass p their k = 2p, 2p + 1
  const int nu = (d.B * NW - unit + units - 1) / units;
  const int np = (nu + 1) / 2;
  for (int p = rank; p < np; p += PAIR ? 2 : 1) {
    const int k0 = 2 * p;
    const int ns = nu - k0 < 2 ? nu - k0 : 2;
    const int bs[2] = {unit + k0 * units, unit + (k0 + 1) * units};
    bf16* op = ops + (size_t)p * PASS_ROWS * SB_OPW;  // the pass's rows
    // the flat index of the pass's row r in the window-major [B nw, 16]
    // layout (the windows by a select: an index into bs would go to
    // memory), and its token
    auto tok = [&](int r) { return (r >> 4 ? bs[1] : bs[0]) * NT + (r & 15); };
    auto row = [&](int r) { return row_of(r >> 4 ? bs[1] : bs[0], r & 15); };
    // norm1's backward from d(xn) in dq, then d(x) to device memory
    auto norm1_bwd = [&] {
      ln_bwd_rows<PASS_ROWS, SB_C>(xs, dq, dq, nullptr, SB_LDX, f.norm1_s,
                                   gln, gln + C, stats);
      for (int i = threadIdx.x; i < ns * NT * (C / 8); i += blockDim.x) {
        const int r = i / (C / 8), c = (i - r * (C / 8)) * 8;
        *reinterpret_cast<uint4*>(static_cast<bf16*>(a.d_x) +
                                  (size_t)row(r) * C + c) =
            *reinterpret_cast<const uint4*>(dq + r * SB_LDX + c);
      }
      __syncthreads();
      QV_STAMP(swa_bwd, 7);
    };
    stage(xs, f.x, bs, ns);
    stage(dO, a.d_out, bs, ns);
    if (zero_attn) stage(dq, a.d_xn, bs, ns);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    QV_STAMP(swa_bwd, 1);
    // d(out) through the proj dropout (n = 64: the product with 1 / keep)
    if (d.train && d.drop_on)
      for (int i = threadIdx.x; i < PASS_ROWS * C; i += blockDim.x) {
        const int r = i / C, c = i - r * C;
        bf16* p = dO + r * SB_LDX + c;
        const unsigned idx = (unsigned)(tok(r) * C + c);
        const float v = to_f<bf16>(*p);
        *p = from_f<bf16>(PAIR ? drop_r(d, SWA_PROJ, idx, v, inv_keep)
                               : drop(d, SWA_PROJ, idx, v));
      }
    if (zero_attn) {
      // a guarded branch: no gradient passes through its attention, so
      // only proj's bias learns (its input is zero), and d(xn) is the
      // cotangent of xn alone
      for (int i = threadIdx.x; i < PASS_ROWS * SB_LDX; i += blockDim.x)
        att[i] = zero;
      __syncthreads();
      save_rows(op + SB_OP_ATT, SB_OPW, att, SB_LDX, C);
      save_rows(op + SB_OP_DO, SB_OPW, dO, SB_LDX, C);
      norm1_bwd();
      continue;
    }
    // ---- recompute ---------------------------------------------------
    ln_rows<PASS_ROWS, SB_C>(xs, dq, SB_LDX, f.norm1_s, f.norm1_b);
    __syncthreads();
    save_rows(op + SB_OP_XN, SB_OPW, dq, SB_LDX, C);
    for (int w = 0; w < 3; ++w)   // q, k, v = xn @ W + b
      gemm_pass<192, 3>(dq, SB_LDX, m.w + SB_QKV + w * C, 3 * C, C, ring,
                        [&](int r, int c, float v0, float v1) {
                          const float* b = f.qkv_b + w * C;
                          store_bf16x2(qkv + r * SB_LDQ + w * C + c,
                                       pack_bf16x2(dense_out(v0, b[c]),
                                                   dense_out(v1, b[c + 1])));
                        });
    __syncthreads();
    // kc | vc = rnd(E^T @ k | v): unit u = (sample, k or v, 16-key tile,
    // 96-column half), two a warp
    for (int u = warp; u < 16; u += NTHREADS / 32) {
      const int s = u >> 3, w = (u >> 2) & 1, mt = (u >> 1) & 1, ch = u & 1;
      float acc[12][4];
#pragma unroll
      for (int j = 0; j < 12; ++j)
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      unsigned af[4];
      load_a(af, et + (w * SB_LK + mt * 16) * SB_LDE, SB_LDE, lane);
#pragma unroll
      for (int np6 = 0; np6 < 6; ++np6) {
        unsigned bf[4];
        load_b_kn(bf, qkv + 16 * s * SB_LDQ + (1 + w) * C + ch * 96 +
                          16 * np6,
                  SB_LDQ, lane);
        mma_bf16_16816(acc[2 * np6], af, bf);
        mma_bf16_16816(acc[2 * np6 + 1], af, bf + 2);
      }
#pragma unroll
      for (int j = 0; j < 12; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          store_bf16x2(kcv(s, w) + (mt * 16 + g + 8 * hf) * SB_LDX +
                           ch * 96 + 8 * j + 2 * t,
                       pack_bf16x2(acc[j][2 * hf], acc[j][2 * hf + 1]));
    }
    __syncthreads();
    QV_STAMP(swa_bwd, 2);
    // the attention: warp (sample s, head h), 32 compressed + S bank keys
    const int s = warp >> 2, h = warp & 3, hc = h * ATT_D;
    const AttnMask am{attn_drop(d, SWA_ATTN),
                      (unsigned)bs[s] * SB_H * NT * kvn, h, kvn};
    const bf16* const kt[3] = {kcv(s, 0), kcv(s, 0) + 16 * SB_LDX, bk};
    const bf16* const vt[3] = {kcv(s, 1), kcv(s, 1) + 16 * SB_LDX, bv};
    const bf16* qs = qkv + 16 * s * SB_LDQ + hc;   // the warp's q
    unsigned qa[3][4];
#pragma unroll
    for (int ks = 0; ks < 3; ++ks) load_a(qa[ks], qs + 16 * ks, SB_LDQ, lane);
    float sp[6][4];   // n = 64: the probabilities, kept for the backward
    if constexpr (PAIR) {
      attn_probs<3, true>(qa, kt, SB_LDX, hc, kvn, sp);
      attn_pv_train<3, true>(sp, vt, SB_LDX, hc, am, att + 16 * s * SB_LDX,
                             SB_LDX);
    } else {
      warp_attention_train<3>(qa, kt, vt, SB_LDX, hc, kvn, am,
                              att + 16 * s * SB_LDX, SB_LDX);
    }
    __syncthreads();
    QV_STAMP(swa_bwd, 3);
    // ---- proj --------------------------------------------------------
    save_rows(op + SB_OP_ATT, SB_OPW, att, SB_LDX, C);
    save_rows(op + SB_OP_DO, SB_OPW, dO, SB_LDX, C);
    gemm_pass<192, 3>(dO, SB_LDX, m.w + SB_PROJT, C, C, ring,
                      [&](int r, int c, float v0, float v1) {
                        store_bf16x2(att + r * SB_LDX + c,
                                     pack_bf16x2(v0, v1));
                      });
    __syncthreads();
    QV_STAMP(swa_bwd, 4);
    // ---- attention: dq, dS, P; this warp's d(kc), d(vc) in place -------
    if constexpr (PAIR) {
      attn_bwd_p<3, true>(sp, kt, vt, SB_LDX, hc, am, att + 16 * s * SB_LDX,
                          SB_LDX, dq + 16 * s * SB_LDX, SB_LDX,
                          ds + 16 * s * SB_LDX + hc,
                          pu + 16 * s * SB_LDX + hc, SB_LDX);
    } else {
#pragma unroll
      for (int ks = 0; ks < 3; ++ks)
        load_a(qa[ks], qs + 16 * ks, SB_LDQ, lane);
      warp_attention_bwd<3>(qa, kt, vt, SB_LDX, hc, kvn, am,
                            att + 16 * s * SB_LDX, SB_LDX,
                            dq + 16 * s * SB_LDX, SB_LDX,
                            ds + 16 * s * SB_LDX + hc,
                            pu + 16 * s * SB_LDX + hc, SB_LDX);
    }
    __syncwarp();
    for (int w = 0; w < 2; ++w)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        float acc[3][2][4];
        if (w)
          key_grads<1>(pu + 16 * s * SB_LDX + hc + 16 * mt, SB_LDX,
                       att + 16 * s * SB_LDX + hc, SB_LDX, acc);
        else
          key_grads<1>(ds + 16 * s * SB_LDX + hc + 16 * mt, SB_LDX, qs,
                       SB_LDQ, acc);
#pragma unroll
        for (int c3 = 0; c3 < 3; ++c3)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf)
              store_bf16x2(kcv(s, w) + (16 * mt + g + 8 * hf) * SB_LDX + hc +
                               16 * c3 + 8 * j + 2 * t,
                           pack_bf16x2(acc[c3][j][2 * hf],
                                       acc[c3][j][2 * hf + 1]));
      }
    __syncthreads();
    QV_STAMP(swa_bwd, 5);
    {  // the bank keys: warp (k or v, head), summed over the pass's rows
      const int w = warp >> 2, hb = (warp & 3) * ATT_D;
      float acc[3][2][4];
      if (w)
        key_grads<2>(pu + hb + SB_LK, SB_LDX, att + hb, SB_LDX, acc);
      else
        key_grads<2>(ds + hb + SB_LK, SB_LDX, qkv + hb, SB_LDQ, acc);
#pragma unroll
      for (int c3 = 0; c3 < 3; ++c3)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) gbank[c3][j][e] += acc[c3][j][e];
    }
    // ---- the Linformer mix -------------------------------------------
    if (warp < 4) {  // d(E)[n, m] = sum_c k[n, c] d(kc)[m, c]: (k or v,
                     // 16 of the 32 m), summed over the samples
      const int w = warp >> 1, m0 = 16 * (warp & 1);
      for (int s2 = 0; s2 < ns; ++s2)
#pragma unroll
        for (int ks = 0; ks < C / 16; ++ks) {
          unsigned af[4], bf[4];
          load_a(af, qkv + 16 * s2 * SB_LDQ + (1 + w) * C + 16 * ks, SB_LDQ,
                 lane);
          load_b_nk(bf, kcv(s2, w) + m0 * SB_LDX + 16 * ks, SB_LDX, lane);
          mma_bf16_16816(ge[0], af, bf);
          mma_bf16_16816(ge[1], af, bf + 2);
        }
    }
    __syncthreads();
    // n = 64: the cotangent of xn into ds (free now), for d(xn)'s epilogue
    // (gemm_pass's first wait completes it)
    if constexpr (PAIR) {
      stage(ds, a.d_xn, bs, ns);
      cp_async_commit();
    }
    // d(q) beside d(k), d(v) (q is read no more)
    for (int i = threadIdx.x; i < PASS_ROWS * (C / 8); i += blockDim.x) {
      const int r = i / (C / 8), c = (i - r * (C / 8)) * 8;
      *reinterpret_cast<uint4*>(qkv + r * SB_LDQ + c) =
          *reinterpret_cast<const uint4*>(dq + r * SB_LDX + c);
    }
    {  // d(k | v)[n, c] = sum_m E[n, m] d(kc | vc)[m, c] over k | v: warp
       // (sample, k or v, 96-column half)
      const int s2 = warp >> 2, w = (warp >> 1) & 1, ch = warp & 1;
      float acc[12][4];
#pragma unroll
      for (int j = 0; j < 12; ++j)
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        unsigned af[4];
        load_a(af, en + w * NT * SB_LDEN + 16 * ks, SB_LDEN, lane);
#pragma unroll
        for (int np6 = 0; np6 < 6; ++np6) {
          unsigned bf[4];
          load_b_kn(bf, kcv(s2, w) + 16 * ks * SB_LDX + ch * 96 + 16 * np6,
                    SB_LDX, lane);
          mma_bf16_16816(acc[2 * np6], af, bf);
          mma_bf16_16816(acc[2 * np6 + 1], af, bf + 2);
        }
      }
#pragma unroll
      for (int j = 0; j < 12; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          store_bf16x2(qkv + (16 * s2 + g + 8 * hf) * SB_LDQ + (1 + w) * C +
                           ch * 96 + 8 * j + 2 * t,
                       pack_bf16x2(acc[j][2 * hf], acc[j][2 * hf + 1]));
    }
    __syncthreads();
    QV_STAMP(swa_bwd, 6);
    // ---- the qkv kernel and norm1: d(xn) = d(qkv) @ W^T + d_xn ----------
    save_rows(op + SB_OP_DQKV, SB_OPW, qkv, SB_LDQ, 3 * C);
    gemm_pass<192, 3>(qkv, SB_LDQ, m.w + SB_QKVT, C, 3 * C, ring,
                      [&](int r, int c, float v0, float v1) {
                        if ((r >> 4) < ns) {
                          unsigned u;
                          if constexpr (PAIR)
                            u = *reinterpret_cast<const unsigned*>(
                                ds + r * SB_LDX + c);
                          else
                            u = *reinterpret_cast<const unsigned*>(
                                static_cast<const bf16*>(a.d_xn) +
                                (size_t)row(r) * C + c);
                          v0 += bf16x2_lo(u);
                          v1 += bf16x2_hi(u);
                        }
                        store_bf16x2(dq + r * SB_LDX + c,
                                     pack_bf16x2(v0, v1));
                      });
    __syncthreads();
    norm1_bwd();
  }
  if constexpr (PAIR) {
    // ---- the cluster's tail: this CTA's bank keys' gradients and d(E)
    // to shared memory (norm1's are in gln) for the pair's sums --------
    float* own = reinterpret_cast<float*>(pu);   // [2][16][C], [2][16][32]
    {
      const int w = warp >> 2, hb = (warp & 3) * ATT_D;
#pragma unroll
      for (int c3 = 0; c3 < 3; ++c3)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            own[(w * SB_S + g + 8 * (e >> 1)) * C + hb + 16 * c3 + 8 * j +
                2 * t + (e & 1)] = gbank[c3][j][e];
    }
    if (warp < 4) {
      const int w = warp >> 1, m0 = 16 * (warp & 1);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          own[SB_OWN_E + (w * NT + g + 8 * (e >> 1)) * SB_LK + m0 + 8 * j +
              2 * t + (e & 1)] = ge[j][e];
    }
    __threadfence();       // the operand rows, for the partner's reads
    cluster_sync();        // both CTAs' operand rows and sums are written
    QV_STAMP(swa_bwd, 10);
    // the pair's sums in rank order, half the elements each, stored into
    // the slice (the bank keys' past S are not fields)
    pair_sums(own, SB_OWN_E + 2 * NT * SB_LK, [&](int i, float v) {
      if (i >= SB_OWN_E) {
        const int e = i - SB_OWN_E, w = e / (NT * SB_LK);
        sl(w ? gr.e_v : gr.e_k)[e - w * NT * SB_LK] = v;
        return;
      }
      const int w = i / (SB_S * C), e = i - w * SB_S * C;
      if (e < S * C) sl(w ? gr.bank_v : gr.bank_k)[e] = v;
    });
    pair_sums(gln, 2 * C, [&](int i, float v) {
      sl(i < C ? gr.norm1_s : gr.norm1_b)[i % C] = v;
    });
    cluster_arrive();      // this CTA has read the partner's sums
    QV_STAMP(swa_bwd, 9);
    // the weight gradients, half the columns each (rank h: proj's 96 h..,
    // qkv's 288 h..) over both CTAs' rows, each stored once (zeros for
    // the guarded branch's qkv); the staging stays below `own`
    bf16* wst = reinterpret_cast<bf16*>(qv_smem);
    static_assert(WG_SMEM <= SB_BF16 - SB_X - SB_RING, "staging below pu");
    const int rows = PASS_ROWS * np, hp = 96 * rank, hq = 288 * rank;
    wgrad_stream(ops + SB_OP_ATT, ops + SB_OP_DO + hp, SB_OPW, rows, 96,
                 sl(gr.proj_w) + hp, C, sl(gr.proj_b) + hp, wst);
    if (zero_attn) {
      for (int i = threadIdx.x; i < C * 288; i += NTHREADS)
        sl(gr.qkv_w)[(i / 288) * 3 * C + hq + i % 288] = 0.f;
      for (int i = threadIdx.x; i < 288; i += NTHREADS)
        sl(gr.qkv_b)[hq + i] = 0.f;
    } else {
      wgrad_stream(ops + SB_OP_XN, ops + SB_OP_DQKV + hq, SB_OPW, rows, 288,
                   sl(gr.qkv_w) + hq, 3 * C, sl(gr.qkv_b) + hq, wst);
    }
    QV_STAMP(swa_bwd, 8);
    cluster_wait();        // the partner has read this CTA's sums
    return;
  }
  // the weight gradients over every row of the block, each stored once
  // into the slice (zeros for the guarded branch's qkv)
  auto wgrad = [&](int ao, int K, int bo, int N, float* w, float* bias,
                   int ldg) {
    wgrad_block(ops + ao, ops + bo, SB_OPW, PASS_ROWS * np, K, N, w, ldg,
                bias, reinterpret_cast<bf16*>(qv_smem), SB_BF16);
  };
  wgrad(SB_OP_ATT, C, SB_OP_DO, C, sl(gr.proj_w), sl(gr.proj_b), C);
  if (zero_attn) {
    float* gw = sl(gr.qkv_w);
    float* gb = sl(gr.qkv_b);
    for (int i = threadIdx.x; i < C * 3 * C; i += blockDim.x) gw[i] = 0.f;
    for (int i = threadIdx.x; i < 3 * C; i += blockDim.x) gb[i] = 0.f;
  } else {
    wgrad(SB_OP_XN, C, SB_OP_DQKV, 3 * C, sl(gr.qkv_w), sl(gr.qkv_b),
          3 * C);
  }
  QV_STAMP(swa_bwd, 8);
  // the sums kept over the passes: norm1's, d(E), the bank rows'
  for (int i = threadIdx.x; i < C; i += blockDim.x) {
    sl(gr.norm1_s)[i] = gln[i];
    sl(gr.norm1_b)[i] = gln[C + i];
  }
  if (warp < 4) {
    const int w = warp >> 1, m0 = 16 * (warp & 1);
    float* gE = sl(w ? gr.e_v : gr.e_k);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        gE[(g + 8 * (e >> 1)) * SB_LK + m0 + 8 * j + 2 * t + (e & 1)] =
            ge[j][e];
  }
  {
    const int w = warp >> 2, hb = (warp & 3) * ATT_D;
    float* gb = sl(w ? gr.bank_v : gr.bank_k);
#pragma unroll
    for (int c3 = 0; c3 < 3; ++c3)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = g + 8 * (e >> 1);
          if (key < S)
            gb[key * C + hb + 16 * c3 + 8 * j + 2 * t + (e & 1)] =
                gbank[c3][j][e];
        }
  }
  QV_STAMP(swa_bwd, 9);
}

}  // namespace qv

// bf16 at hqavit_c100's widths: `a` as for qv_unit_swa_bwd with a
// per-block scratch of swa_bwd_mma_scratch_floats(d), the bf16 weights
// beside it (SwaBwdMmaArgs); the workspace `gws` may hold anything (the
// kernel stores every field).  ERR_ARGS for any other geometry or type
// (the wrapper checks them first, swa_bwd_mma_error).
extern "C" int qv_unit_swa_bwd_mma(const qv::SwaBwdArgs* a, const void* w,
                                   int is_bf16, void* stream) {
  const qv::Dims& d = a->f.d;
  if (!is_bf16 || d.n != qv::NT || d.nw != 1 ||
      d.c != qv::SB_C || d.heads != qv::SB_H || d.lin_k != qv::SB_LK ||
      d.bank_s > qv::SB_S || d.grid > d.B)
    return qv::ERR_ARGS;
  const qv::SwaBwdMmaArgs m{*a, static_cast<const qv::bf16*>(w)};
  const int rc = qv_launch(qv::swa_bwd_mma_kernel<1>, m, qv::SB_SMEM_BYTES,
                           stream, d.grid);
  if (rc != 0) return rc;
  return qv_reduce(a->c.gws, a->c.grad, d.grid, a->c.wstride, d.rgrid, stream);
}

// bf16 at hqavit_tiny_in's widths, n = 64 in four 4x4 windows on an 8x8
// grid (swa_bwd_mma_kernel<4>): d.grid clusters of two CTAs (at most one
// a window), one gradient slice each in `gws` (which may hold anything:
// the kernel stores every field), a scratch of
// swa_bwd_mma_scratch_floats(d) a cluster.  A cluster launch the card
// refuses returns its CUDA error.
extern "C" int qv_unit_swa_bwd_mma64(const qv::SwaBwdArgs* a, const void* w,
                                     int is_bf16, void* stream) {
  const qv::Dims& d = a->f.d;
  if (!is_bf16 || d.n != 4 * qv::NT || d.nw != 4 ||
      d.side != 8 || d.c != qv::SB_C || d.heads != qv::SB_H ||
      d.lin_k != qv::SB_LK || d.bank_s > qv::SB_S || d.grid > 4 * d.B ||
      a->c.wstride % 2 != 0)   // (wgrad_stream stores column pairs)
    return qv::ERR_ARGS;
  const qv::SwaBwdMmaArgs m{*a, static_cast<const qv::bf16*>(w)};
  const int rc = qv_launch_cluster(qv::swa_bwd_mma_kernel<4>, m,
                                   qv::SB_SMEM_BYTES, stream, d.grid, 2);
  if (rc != 0) return rc;
  return qv_reduce(a->c.gws, a->c.grad, d.grid, a->c.wstride, d.rgrid, stream);
}

extern "C" int qv_unit_swa_bwd_mma_smem(const qv::Dims*) {
  return qv::SB_SMEM_BYTES;
}

extern "C" int qv_unit_swa_bwd_mma_scratch(const qv::Dims* d) {
  return qv::swa_bwd_mma_scratch_floats(*d);
}

extern "C" int qv_unit_swa_bwd_mma64_smem(const qv::Dims*) {
  return qv::SB_SMEM_BYTES;
}

extern "C" int qv_unit_swa_bwd_mma64_scratch(const qv::Dims* d) {
  return qv::swa_bwd_mma_scratch_floats(*d);
}

// CTAs of swa_bwd_mma_kernel<4> resident per SM and its two-CTA clusters
// resident at once on the card (0 on the host)
extern "C" int qv_unit_swa_bwd_mma64_occupancy(int* per_sm, int* clusters) {
  return qv_cluster_occupancy(qv::swa_bwd_mma_kernel<4>, qv::SB_SMEM_BYTES,
                              2, per_sm, clusters);
}
