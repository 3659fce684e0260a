// Unit 4 of the fused block (cross branch + block tail), forward in
// training at n = 64 (hqavit_tiny_in / hqavit_proc_tin, an 8x8 grid) in
// bf16: cross_tail_train64_kernel, the C entry
// qv_unit_cross_tail_mma_train64.
//
// Replaces, with cross_tail_mma_kernel (unit_cross_tail.cu), the TPU
// unit qavit_tpu/kernels/fused_kernels.py make_cores.core_cross_tail
// (fused_cores.py:699 cross_bd, :779 tail_bd), run through
// fused_pallas.py:190-212 fwd_call.
//
// Bound on the H100 at B=128: five [128, 64, 192] bf16 inputs and the
// output, 20 MB (~6 us at 3.35 TB/s), against 3.1 GFLOP: the bytes bound
// it.  The single-block design (cross_tail_mma_kernel's, a sample a block
// at B=128) spent its time in a chain of 42 ring slices and dropout
// epilogues over 64 rows on one CTA of 8 warps an SM (PERF.md section 6,
// its phases); this kernel halves each CTA's rows so that two CTAs, 16
// warps, share an SM, and scales every kept value by 1 / keep.  Time:
// PERF.md section 6 row 4 @n64 train.
#include "cluster.cuh"
#include "cross_tail_mma.cuh"
#include "unit_cross_tail.cuh"

QV_STAMPS_DEFINE(cross_tail_fwd,
                 "bank K|V prologue,staging,cq,attention,cp,LN and compress,"
                 "bottleneck,norm2 and fc1,dwconv and its LNs,fc2,store,"
                 "guard,cluster barriers")

namespace qv {

// A CTA's half of a sample, grid rows 4 rank .. 4 rank + 3, and its
// buffers of that many rows
constexpr int CT64_ROWS = CT_N / 2;
constexpr int CT64_X = CT64_ROWS * CT_LDX;      // one [32, C] buffer
constexpr int CT64_SIDE = 8;                    // the sample's grid side
static_assert(CT64_ROWS == PASS_ROWS, "gemm_pass's rows");
static_assert(RING_KS * CT_LDX >= CT64_SIDE * CT_LDH, "the halo in the ring");
constexpr int CT64_SMEM_BYTES =
    2 * (2 * CT_S * CT_LDX          // projected bank k, v
         + 5 * CT64_X               // xa, x1, br[0..2]
         + CT_STAGES * RING_KS * CT_LDX)  // weight slices; the halo row
    + 4 * (int)sizeof(int);         // the guard's flags
static_assert(2 * CT64_SMEM_BYTES <= 228 * 1024 - 2 * 1024,
              "two CTAs an SM");
static_assert(2 * CT_S * CT_C % NTHREADS == 0 &&
                  CT64_SIDE * CT_HID % NTHREADS == 0,
              "whole rounds of a block's threads");

// One two-CTA cluster a sample: CTA rank r its grid rows 4r..4r+3 (the
// sample's token rows 32r..), each step but the dwconv on its own rows
// through cross_tail_mma_kernel's products (gemm_pass: 32 rows, the
// weight streamed once a CTA), so that two CTAs share an SM and B=128's
// 256 CTAs are resident at once.  The 3x3 dwconv reads the grid row next
// to its half (8 tokens x 96 channels) from the partner's shared memory
// between cluster barriers: a barrier after both dwconv inputs are
// written, the copy into the free ring, an arrival after the read, which
// the CTA waits for before its next sample's staging rewrites the buffer.
// The bank's K|V projections once a cluster: rank 0 forms k, rank 1 v,
// each copying the other's through distributed shared memory.  Masks:
// the same counter hash at the same flat indices as cross_tail_mma_kernel,
// every kept value the product with 1 / keep and the attention softmax by
// its rows' reciprocal sums (warp_attention_train<1, true>), each within
// an ulp of the quotient; every bf16 rounding point kept.  The
// batch-wide NaN guard: finish_guard_pair, the redo on the last cluster.
// The buffers ([32, C]; h, h2 [32, 96] in the space of a [32, C] one):
//   xa   xn; then the cross attention rows (q stays in registers); then
//        the cross output, normed in place; then the weighted concat
//   x1   x; then x1 = x + bottleneck; then the block output
//   br   the branch outputs swa, msda, cga, each normed in place; then
//        br[0] the bottleneck hidden, then the CCF-FFN hidden (the
//        partner's halo source), br[1] norm2(x1), br[2] the dwconv output
//   ring the weight slices; during the dwconv the partner's grid row
__global__ void __launch_bounds__(NTHREADS, 2)
    cross_tail_train64_kernel(CrossTailMmaArgs m) {
  QV_SMEM_DECL
  QV_STAMP(cross_tail_fwd, -1);
  constexpr int SN = CT64_SIDE * CT64_SIDE;
  const CrossTailArgs& a = m.f;
  const Dims& d = a.d;
  const int S = d.bank_s, C = CT_C, HID = CT_HID;
  const int rank = (int)cluster_rank();
  const int clusters = (int)gridDim.x / 2;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  bf16* kb = reinterpret_cast<bf16*>(qv_smem);
  bf16* vb = kb + CT_S * CT_LDX;
  bf16* xa = vb + CT_S * CT_LDX;
  bf16* x1 = xa + CT64_X;
  bf16* br[3] = {x1 + CT64_X, x1 + 2 * CT64_X, x1 + 3 * CT64_X};
  bf16* ring = x1 + 4 * CT64_X;
  int* flags = reinterpret_cast<int*>(ring + CT_STAGES * RING_KS * CT_LDX);
  bf16* halo = ring;                 // [8][CT_LDH] during the dwconv
  const float inv_keep = 1.f / d.keep;
  auto dropout = [&](int key, unsigned idx, float v) {
    return drop_r(d, key, idx, v, inv_keep);
  };
  auto put = [](bf16* p, float v0, float v1) {
    store_bf16x2(p, pack_bf16x2(v0, v1));
  };
  if (threadIdx.x == 0) flags[2] = 0;      // NaN seen

  // the CTA's rows of sample b's five inputs: xn, x, swa, msda, cga
  auto stage = [&](int b) {
    const size_t off = ((size_t)b * SN + CT64_ROWS * rank) * C;
    const void* src[5] = {a.xn, a.x, a.swa, a.msda, a.cga};
    bf16* dst[5] = {xa, x1, br[0], br[1], br[2]};
#pragma unroll
    for (int k = 0; k < 5; ++k)
      for (int i = threadIdx.x; i < CT64_ROWS * (C / 8); i += blockDim.x) {
        const int r = i / (C / 8), c = (i - r * (C / 8)) * 8;
        cp_async_16(dst[k] + r * CT_LDX + c,
                    static_cast<const bf16*>(src[k]) + off + r * C + c);
      }
    cp_async_commit();
  };
  const int b0 = (int)blockIdx.x / 2;
  if (b0 < d.B) stage(b0);

  // per cluster: the bank's K|V projections, rank 0 k and rank 1 v.  Its
  // bank rows rounded into rows 16 rank.. of kb | vb (the other 16 zero),
  // times [ck | cv]'s half, in place: rows 16 rank.. are kb or vb
  // (a fixed count a thread, unrolled, so that its loads are in flight at
  // once: they come from L2)
#pragma unroll
  for (int k = 0; k < 2 * CT_S * CT_C / NTHREADS; ++k) {
    const int i = threadIdx.x + k * NTHREADS;
    const int r = i / C, c = i - r * C, rr = r % CT_S;
    const float* src = rank ? a.bank_v : a.bank_k;
    kb[r * CT_LDX + c] = from_f<bf16>(
        r / CT_S == rank && rr < S ? rnd<bf16>(src[rr * C + c]) : 0.f);
  }
  __syncthreads();
  {
    const float* bias = rank ? a.cv_b : a.ck_b;
    bool nan_seen = false;
    gemm_pass<192, CT_STAGES>(
        kb, CT_LDX, m.w1 + CT_CK + rank * C, CT_W1, C, ring,
        [&](int r, int c, float v0, float v1) {
          if (r / CT_S != rank) return;
          const bool in = r % CT_S < S;
          const float y0 = in ? dense_out(v0, bias[c]) : 0.f;
          const float y1 = in ? dense_out(v1, bias[c + 1]) : 0.f;
          nan_seen = nan_seen || isnan(y0) || isnan(y1);
          put(kb + r * CT_LDX + c, y0, y1);
        });
    if (d.guard && nan_seen) flags[2] = 1;
  }
  cluster_sync();            // both halves of the projected bank are written
  {  // the partner's half into this CTA's
    const int o = (rank ^ 1) * CT_S * CT_LDX;
    const bf16* peer = cluster_peer(kb + o, (unsigned)rank ^ 1u);
    for (int i = threadIdx.x; i < CT_S * (C / 8); i += blockDim.x) {
      const int r = i / (C / 8), c = (i - r * (C / 8)) * 8;
      *reinterpret_cast<uint4*>(kb + o + r * CT_LDX + c) =
          *reinterpret_cast<const uint4*>(peer + r * CT_LDX + c);
    }
  }
  float fw[4];
  fusion_weights(a.fusion, fw);
  QV_STAMP(cross_tail_fwd, 0);

  // the products of 192 columns: warp w rows 16 mt.. and columns 48 hh..,
  // which in cq are head hh's
  const int mt = warp & 1, hh = warp >> 1;
  bool pending = false;      // an arrival after a halo read, not waited for
  auto sample = [&](int b, bool staged, bool zero_attn) {
    // the flat index of the CTA's row r and column c in a [B, n, width]
    // layout; the sample's drop-path factors
    const int t0 = b * SN + CT64_ROWS * rank;
    auto idx = [&](int r, int c, int width) {
      return (unsigned)((t0 + r) * width + c);
    };
    const float dp1 = drop_path_mul(d, DP1, b);
    const float dp2 = drop_path_mul(d, DP2, b);
    __syncthreads();         // the last sample's rows are stored
    if (pending) {           // the partner has read this CTA's halo rows
      QV_STAMP(cross_tail_fwd, 10);
      cluster_wait();
      QV_STAMP(cross_tail_fwd, 12);
      pending = false;
    }
    if (!staged) stage(b);
    cp_async_wait<0>();
    __syncthreads();
    QV_STAMP(cross_tail_fwd, 1);
    // ---- cross branch: q of head hh, in registers ----------------------
    unsigned qa[3][4];
    {
      float acc[1][6][4];
      ring_gemm<1, 6, CT_STAGES>(xa + mt * 16 * CT_LDX, CT_LDX,
                                 m.w1 + CT_CQ, CT_W1, C, C, ring, CT_LDX,
                                 48 * hh, acc);
      bool nan_seen = false;
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        const int col = 48 * hh + 8 * j + 2 * t;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[0][j][e] = dense_out(acc[0][j][e], a.cq_b[col + (e & 1)]);
          nan_seen = nan_seen || isnan(acc[0][j][e]);
        }
      }
#pragma unroll
      for (int ks = 0; ks < 3; ++ks) {
        const float* c0 = acc[0][2 * ks];
        const float* c1 = acc[0][2 * ks + 1];
        qa[ks][0] = pack_bf16x2(c0[0], c0[1]);
        qa[ks][1] = pack_bf16x2(c0[2], c0[3]);
        qa[ks][2] = pack_bf16x2(c1[0], c1[1]);
        qa[ks][3] = pack_bf16x2(c1[2], c1[3]);
      }
      if (nan_seen && d.guard && !zero_attn) flags[2] = 1;
    }
    QV_STAMP(cross_tail_fwd, 2);
    {  // xn is read: head hh's attention rows to xa, over the S projected
       // bank keys; the warp's 16 query rows are rows 32 rank + 16 mt.. of
       // sample b, whose attention dropout the mask replays
      const bf16* const kt[1] = {kb};
      const bf16* const vt[1] = {vb};
      bf16* out = xa + mt * 16 * CT_LDX;
      const int hc = hh * ATT_D;
      if (zero_attn) {
        for (int e = lane; e < 16 * ATT_D / 2; e += 32) {
          const int r = e / (ATT_D / 2), c = 2 * (e - r * (ATT_D / 2));
          put(out + r * CT_LDX + hc + c, 0.f, 0.f);
        }
      } else {
        const AttnMask am{attn_drop(d, CROSS_ATTN),
                          (unsigned)(b * CT_H * SN + CT64_ROWS * rank +
                                     16 * mt) * S,
                          hh, S, SN};
        if (warp_attention_train<1, true>(qa, kt, vt, CT_LDX, hc, S, am,
                                          out, CT_LDX) &&
            d.guard)
          flags[2] = 1;
      }
    }
    __syncthreads();
    QV_STAMP(cross_tail_fwd, 3);
    // the cross branch output: att @ W_cp + b and its dropout, in place
    gemm_pass<192, CT_STAGES>(
        xa, CT_LDX, m.w1 + CT_CP, CT_W1, C, ring,
        [&](int r, int c, float v0, float v1) {
          put(xa + r * CT_LDX + c,
              dropout(CROSS_PROJ, idx(r, c, C), dense_out(v0, a.cp_b[c])),
              dropout(CROSS_PROJ, idx(r, c + 1, C),
                      dense_out(v1, a.cp_b[c + 1])));
        });
    __syncthreads();
    QV_STAMP(cross_tail_fwd, 4);
    // ---- tail: per-branch LN + compress, softmax-weighted concat -------
    bf16* const bi[4] = {br[0], br[1], br[2], xa};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      ln_rows<CT64_ROWS, CT_C>(bi[i], bi[i], CT_LDX, a.norm_s[i],
                               a.norm_b[i]);
    __syncthreads();
    {  // warp (branch hh, rows 16 mt..): its 48 columns of the concat,
       // to xa once every branch is read
      const bf16* src = hh == 0 ? br[0] : hh == 1 ? br[1] : hh == 2 ? br[2]
                                                                   : xa;
      float acc[1][6][4];
      ring_gemm<1, 6, CT_STAGES>(src + mt * 16 * CT_LDX, CT_LDX,
                                 m.w1 + CT_COMP, CT_W1, C, C, ring, CT_LDX,
                                 CT_DC * hh, acc);
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        const int cc = 8 * j + 2 * t;
        const float bb0 = a.comp_b[hh][cc], bb1 = a.comp_b[hh][cc + 1];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          put(xa + (mt * 16 + g + 8 * hf) * CT_LDX + CT_DC * hh + cc,
              rnd<bf16>(dense_out(acc[0][j][2 * hf], bb0) * fw[hh]),
              rnd<bf16>(dense_out(acc[0][j][2 * hf + 1], bb1) * fw[hh]));
      }
    }
    __syncthreads();
    QV_STAMP(cross_tail_fwd, 5);
    // ---- bottleneck MLP and the first residual ------------------------
    bf16* h = br[0];
    gemm_pass<96, CT_STAGES>(  // h = dropout(rnd(gelu(fused @ W_bn1 + b)))
        xa, CT_LDX, m.w1 + CT_BN1, CT_W1, C, ring,
        [&](int r, int c, float v0, float v1) {
          put(h + r * CT_LDH + c,
              dropout(BN1, idx(r, c, HID),
                      rnd<bf16>(gelu_f(dense_out(v0, a.bn1_b[c])))),
              dropout(BN1, idx(r, c + 1, HID),
                      rnd<bf16>(gelu_f(dense_out(v1, a.bn1_b[c + 1])))));
        });
    __syncthreads();
    // x1 = rnd(x + y2), y2 = the dropout and drop-path of h @ W_bn2 + b
    gemm_pass<192, CT_STAGES>(
        h, CT_LDH, m.w2 + CT_BN2, CT_W2, HID, ring,
        [&](int r, int c, float v0, float v1) {
          bf16* p = x1 + r * CT_LDX + c;
          const float v[2] = {v0, v1};
          float o[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float y = rnd<bf16>(dropout(BN2, idx(r, c + e, C),
                                        dense_out(v[e], a.bn2_b[c + e])));
            y = rnd<bf16>(y * dp1);
            o[e] = to_f<bf16>(p[e]) + y;
          }
          put(p, o[0], o[1]);
        });
    __syncthreads();
    QV_STAMP(cross_tail_fwd, 6);
    // ---- CCF-FFN ---------------------------------------------------------
    ln_rows<CT64_ROWS, CT_C>(x1, br[1], CT_LDX, a.norm2_s, a.norm2_b);
    __syncthreads();
    gemm_pass<96, CT_STAGES>(  // h = rnd(gelu(norm2(x1) @ W_fc1 + b))
        br[1], CT_LDX, m.w1 + CT_FC1, CT_W1, C, ring,
        [&](int r, int c, float v0, float v1) {
          put(h + r * CT_LDH + c, gelu_f(dense_out(v0, a.fc1_b[c])),
              gelu_f(dense_out(v1, a.fc1_b[c + 1])));
        });
    __syncthreads();
    QV_STAMP(cross_tail_fwd, 7);
    ln_rows<CT64_ROWS, CT_HID>(h, h, CT_LDH, a.dwn_s, a.dwn_b);
    QV_STAMP(cross_tail_fwd, 8);
    cluster_sync();          // both CTAs' dwconv inputs are written
    QV_STAMP(cross_tail_fwd, 12);
    {  // the partner's grid row next to this half: its rows 0-7 (rank 0
       // needs grid row 4), or 24-31 (rank 1 needs grid row 3)
      const bf16* peer = cluster_peer(
          h + (rank ? CT64_ROWS - CT64_SIDE : 0) * CT_LDH, (unsigned)rank ^ 1u);
      for (int i = threadIdx.x; i < CT64_SIDE * (HID / 8); i += blockDim.x) {
        const int r = i / (HID / 8), c = (i - r * (HID / 8)) * 8;
        *reinterpret_cast<uint4*>(halo + r * CT_LDH + c) =
            *reinterpret_cast<const uint4*>(peer + r * CT_LDH + c);
      }
    }
    cluster_arrive();        // this CTA's reads of the partner are done
    pending = true;
    __syncthreads();
    // the 3x3 depthwise correlation on the sample's 8 x 8 grid (zero halo
    // at its edge, bias before the scale), as cross_tail_mma_kernel: a
    // thread walks down one column of the CTA's four grid rows in one
    // channel, its 3x3 window of inputs in registers; grid row gr of the
    // sample is this CTA's row gr - 4 rank, or the partner's in halo
    bf16* h2 = br[2];
#pragma unroll
    for (int uk = 0; uk < CT64_SIDE * CT_HID / NTHREADS; ++uk) {
      const int u = threadIdx.x + uk * NTHREADS;
      const int gj = u / CT_HID, ch = u - gj * CT_HID;
      float k[9];
#pragma unroll
      for (int i = 0; i < 9; ++i) k[i] = a.dw_w[ch * 9 + i];
      const float bias = d.dw_bias ? rnd<bf16>(a.dw_b[ch]) : 0.f;
      const float scale = rnd<bf16>(a.dw_scale[ch]);
      auto in = [&](int gr, int sj) {
        if (gr < 0 || gr >= CT64_SIDE || sj < 0 || sj >= CT64_SIDE)
          return 0.f;
        const int lr = gr - 4 * rank;
        return to_f<bf16>(lr >= 0 && lr < 4
                              ? h[(lr * CT64_SIDE + sj) * CT_LDH + ch]
                              : halo[sj * CT_LDH + ch]);
      };
      const int gr0 = 4 * rank;
      float win[3][3];
#pragma unroll
      for (int kj = 0; kj < 3; ++kj) {
        win[0][kj] = in(gr0 - 1, gj + kj - 1);
        win[1][kj] = in(gr0, gj + kj - 1);
      }
#pragma unroll
      for (int gi = 0; gi < 4; ++gi) {
#pragma unroll
        for (int kj = 0; kj < 3; ++kj)
          win[2][kj] = in(gr0 + gi + 1, gj + kj - 1);
        float acc = 0.f;
#pragma unroll
        for (int ki = 0; ki < 3; ++ki)
#pragma unroll
          for (int kj = 0; kj < 3; ++kj)
            acc = fmaf(win[ki][kj], k[ki * 3 + kj], acc);
        float yv = rnd<bf16>(acc);
        if (d.dw_bias) yv = rnd<bf16>(yv + bias);
        yv = rnd<bf16>(yv * scale);
        h2[(gi * CT64_SIDE + gj) * CT_LDH + ch] = from_f<bf16>(yv);
#pragma unroll
        for (int kj = 0; kj < 3; ++kj) {
          win[0][kj] = win[1][kj];
          win[1][kj] = win[2][kj];
        }
      }
    }
    __syncthreads();
    ln_rows<CT64_ROWS, CT_HID>(h2, h2, CT_LDH, a.pdn_s, a.pdn_b);
    __syncthreads();
    QV_STAMP(cross_tail_fwd, 8);
    {  // y = x1 + f, f = the dropout, gamma and drop-path of h2 @ W_fc2 +
       // b, summed in float32 and rounded once, in place of x1
      const float gamma = a.gamma[0];
      gemm_pass<192, CT_STAGES>(
          h2, CT_LDH, m.w2 + CT_FC2, CT_W2, HID, ring,
          [&](int r, int c, float v0, float v1) {
            bf16* p = x1 + r * CT_LDX + c;
            const float v[2] = {v0, v1};
            float o[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float f = rnd<bf16>(dropout(FFN, idx(r, c + e, C),
                                          dense_out(v[e], a.fc2_b[c + e])));
              f = rnd<bf16>(f * gamma);
              f = rnd<bf16>(f * dp2);
              o[e] = to_f<bf16>(p[e]) + f;
            }
            put(p, o[0], o[1]);
          });
    }
    __syncthreads();
    QV_STAMP(cross_tail_fwd, 9);
    {  // the CTA's rows of the block output, 16 bytes a copy
      bf16* y = static_cast<bf16*>(a.y) + (size_t)t0 * C;
      for (int i = threadIdx.x; i < CT64_ROWS * (C / 8); i += blockDim.x) {
        const int r = i / (C / 8), c = (i - r * (C / 8)) * 8;
        *reinterpret_cast<uint4*>(y + r * C + c) =
            *reinterpret_cast<const uint4*>(x1 + r * CT_LDX + c);
      }
    }
  };
  // the partner's last halo read, before this CTA may exit or rewrite
  auto drain = [&] {
    QV_STAMP(cross_tail_fwd, 10);
    if (pending) cluster_wait();
    pending = false;
    QV_STAMP(cross_tail_fwd, 12);
  };
  for (int b = b0; b < d.B; b += clusters) sample(b, b == b0, false);
  drain();
  if (d.guard)
    finish_guard_pair(a.ws, flags[2], flags, [&] {
      // the redo: every sample with a zero cross attention output
      for (int b = 0; b < d.B; ++b) sample(b, false, true);
      drain();
    });
  QV_STAMP(cross_tail_fwd, 11);
}

}  // namespace qv

// The bf16 tensor-core kernel in training at n = 64 on an 8x8 grid
// (cross_tail_train64_kernel): d.grid clusters of two CTAs, a sample a
// cluster at a time; `a` and the packed weights as for
// qv_unit_cross_tail_mma; ERR_ARGS for any other geometry or type (the
// wrapper checks them first, cross_tail_mma_error).  A cluster launch
// the card refuses returns its CUDA error.
extern "C" int qv_unit_cross_tail_mma_train64(const qv::CrossTailArgs* a,
                                              const void* w1, const void* w2,
                                              int is_bf16, void* stream) {
  const qv::Dims& d = a->d;
  if (!is_bf16 || !d.train || d.n != qv::CT_N || d.side != 8 ||
      d.c != qv::CT_C || d.heads != qv::CT_H || d.bank_s > qv::CT_S ||
      d.ccf_hidden != qv::CT_HID || d.bottleneck_hidden != qv::CT_HID ||
      d.d_c != qv::CT_DC || !d.stab_ccf || !d.stab_dw || d.grid > d.B)
    return qv::ERR_ARGS;
  const qv::CrossTailMmaArgs m{*a, static_cast<const qv::bf16*>(w1),
                               static_cast<const qv::bf16*>(w2)};
  return qv_launch_cluster(qv::cross_tail_train64_kernel, m,
                           qv::CT64_SMEM_BYTES, stream, d.grid, 2);
}

extern "C" int qv_unit_cross_tail_mma_train64_smem(const qv::Dims*) {
  return qv::CT64_SMEM_BYTES;
}

// CTAs of cross_tail_train64_kernel resident per SM and its two-CTA
// clusters resident at once on the card (0 on the host)
extern "C" int qv_unit_cross_tail_mma_train64_occupancy(int* per_sm,
                                                        int* clusters) {
  return qv_cluster_occupancy(qv::cross_tail_train64_kernel,
                              qv::CT64_SMEM_BYTES, 2, per_sm, clusters);
}
