// Unit 4 of the fused block, backward: the VJP of the cross branch and
// the block tail.
//
// Replaces the TPU kernel qavit_tpu/kernels/fused_pallas.py:244 bwd_call
// (pallas_call at :245, bwd_kernel :219-242) for the core `cross_tail`
// (fused_kernels.py:96); PERF.md section 6 row 8.
//
// Per sample: recompute the unit (masks and NaN-guard flag replayed),
// then differentiate the CCF-FFN (fc2, post-dwconv LN, the 0.1 scale,
// the 3x3 depthwise correlation, LN, GELU, fc1, norm2), both drop-path
// residuals, the bottleneck MLP, the softmax fusion weights, the four
// branch LN + compress layers (each branch's LN recomputed from its
// input) and the cross branch (proj, attention, the bank K/V
// projections, q).  d(x), d(xn) and the three branch outputs' cotangents
// are written per sample in the working type; weight and bank gradients
// go to this block's float32 slice, and the reduction pass sums the
// slices in block order.
//
// Bound on the H100 at B=1024 (bf16), as chip_smoke.unit_bwd_work counts
// it: six [B,16,192] inputs and cotangents read, five cotangents written,
// the float32 weights read and their gradients written, 71.4 MB (~21 us
// at 3.35 TB/s), against 18.8 GFLOP (~19 us at 989 TFLOP/s): the bytes
// bound it.
//
// float32, cross_tail_bwd_kernel: the first design, on the CUDA cores
// (TF32 keeps too few digits for the 1e-4 gradient tolerance).  One
// 256-thread block per SM walks the samples with ~201 KB of float32
// shared memory and recomputes through cross_tail_body (the forward's
// code); the six [16, 96] CCF-FFN hidden activations live in a per-block
// float32 scratch in device memory (L2-resident, 36 KB a block); each
// dense_wgrad reads and writes the block's gradient slice.
// Latency-bound.
//
// bf16 at hqavit_c100's widths, cross_tail_bwd_mma_kernel: every dense
// layer on the tensor cores (mma.sync m16n8k16, bf16 operands, float32
// sums) over a pass of two samples (32 rows), every activation and
// cotangent as bf16 in shared memory (215 KB), the pieces in
// mma_ops.cuh.  The recompute follows cross_tail_mma_kernel with the
// training masks: cq, the cross attention with its dropout
// (warp_attention_train), cp, the four LN + compress as one product over
// the packed weights, the fusion, bn1, GELU, bn2, drop-path, norm2, fc1,
// GELU, LN, the dwconv on each sample's 4x4 grid on the CUDA cores, the
// scale, LN and fc2, where gamma's gradient is summed.  The backward runs
// in the float32 kernel's order; each dgrad dy @ W^T streams a transposed
// bf16 weight (made by the wrapper once per call) through the same ring,
// the LayerNorm backwards run eight lanes a row, the attention backward
// one warp per 16 queries and head (warp_attention_bwd).  The dense
// weight gradients in^T @ dy are not summed per pass: each pass saves
// its operand rows (bf16) to the per-block scratch, and at the end the
// block forms each gradient over all its rows (wgrad_block) and stores
// it once into its slice.  Summed into the slice per pass instead, the
// slices (132 x 1.07 MB, more than L2 holds) were read and written
// through HBM four times a launch, ~40% of the kernel's time (1.78 ms a
// launch, against 1.37 ms with the saved rows).  The bank K/V
// projections' cotangents are summed over the block's samples in the
// scratch too, and the projections' gradients formed once a block at the
// end.  Time: PERF.md section 6 row 8.
//
// bf16 at hqavit_tiny_in's widths, n = 64 on an 8x8 grid,
// cross_tail_bwd_mma64_kernel: one two-CTA thread-block cluster a sample,
// CTA rank h the sample's grid rows 4h..4h+3 (32 rows, the n = 16 kernel's
// pass), each row's forward recomputed once.  The 3x3 dwconv couples a
// grid row to its neighbours, so each CTA reads the one grid row of the
// other half next to its own (8 tokens x 96 channels) from the partner's
// shared memory, between cluster barriers: the dwconv's input, then the
// cotangent of its output.  Clusters walk the samples; one gradient slice
// per cluster, each CTA forming half of the dense weight gradients (by
// FLOPs) over both CTAs' saved operand rows and summing its scalar and
// LayerNorm sums with the partner's in rank order: every field stored
// once, so the caller's workspace needs no zeroing.  Bound at B=128 on
// the H100: 36.8 MB against 9.4 GFLOP (~11 us): the bytes bound it.
// Time: PERF.md section 6 row 8 @n64.
#include "cluster.cuh"
#include "mma_ops.cuh"
#include "unit_cross_tail.cuh"

QV_STAMPS_DEFINE(cross_tail_bwd,
                 "bank projections,stage,recompute to the dwconv input,"
                 "dwconv fc2 gamma,backward to d(dwconv out),"
                 "dwconv fc1 norm2 bwd,bottleneck fusion bwd,"
                 "branch LN compress bwd,cross proj attention q bwd,"
                 "weight gradients,bank gradients,cluster barriers")

namespace qv {

__host__ __device__ inline int cross_tail_bwd_smem_floats(const Dims& d) {
  const int c = d.c, S = d.bank_s;
  const int hb = d.bottleneck_hidden;
  const int hmax = d.ccf_hidden > hb ? d.ccf_hidden : hb;
  return 11 * NT * c          // qc, attc, X, cc, fused, x1, fin, z, W1-W3
         + 2 * S * c          // projected bank k, v
         + 2 * NT * hb        // h1, g1
         + 2 * NT * hmax      // two hidden cotangents
         + 3 * pad4(d.heads * NT * S)
         + 4 * NTHREADS + 4   // block sums
         + 4 * NT;            // LN stats
}

__host__ __device__ inline int cross_tail_bwd_scratch_floats(const Dims& d) {
  return 6 * NT * d.ccf_hidden;
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS, 1)
    cross_tail_bwd_kernel(CrossTailBwdArgs a) {
  QV_SMEM_DECL
  __shared__ int bad;
  const CrossTailArgs& f = a.f;
  const Dims& d = f.d;
  const int c = d.c, S = d.bank_s, nh = d.heads, dc = d.d_c;
  const int hb = d.bottleneck_hidden, hc = d.ccf_hidden;
  const int hmax = hc > hb ? hc : hb;
  const int kvn = pad4(nh * NT * S);
  float* qc = qv_smem;
  float* attc = qc + NT * c;
  float* X = attc + NT * c;
  float* cc = X + NT * c;
  float* fused = cc + NT * c;
  float* x1 = fused + NT * c;
  float* fin = x1 + NT * c;
  float* z = fin + NT * c;
  float* W1 = z + NT * c;
  float* W2 = W1 + NT * c;
  float* W3 = W2 + NT * c;
  float* kb = W3 + NT * c;
  float* vb = kb + S * c;
  float* h1 = vb + S * c;
  float* g1 = h1 + NT * hb;
  float* dH1 = g1 + NT * hb;
  float* dH2 = dH1 + NT * hmax;
  float* sc = dH2 + NT * hmax;
  float* pr = sc + kvn;
  float* dp = pr + kvn;
  float* red = dp + kvn;
  float* sums = red + 4 * NTHREADS;
  float* stats = sums + 4;
  float* hs = a.c.scratch +
              (size_t)blockIdx.x * cross_tail_bwd_scratch_floats(d);
  float* h = hs;
  float* hg = h + NT * hc;
  float* hn = hg + NT * hc;
  float* dwb = hn + NT * hc;
  float* dws = dwb + NT * hc;
  float* hp = dws + NT * hc;
  const CrossTailBufs s{W1,  qc,  kb,  vb,  attc, X,   sc, pr, W1,
                        cc,  fused, h1, g1, W2,   x1,  fin, h,  hg,
                        hn,  dwb, dws, hp, z,    W2,  stats};
  const CrossTailGrads& g = a.g;
  const bool zero_attn = d.guard && a.c.flag[1] != 0;
  const float* dwin = d.stab_ccf ? hn : hg;
  const float* pin = d.stab_ccf ? hp : dws;
  const float gamma = d.stab_ccf ? f.gamma[0] : 1.f;
  void* d_out3[3] = {a.d_swa, a.d_msda, a.d_cga};
  const void* branch[3] = {f.swa, f.msda, f.cga};

  cross_tail_prologue<T>(f, a.c.bank_kr, a.c.bank_vr, s);
  for (int b = blockIdx.x; b < d.B; b += gridDim.x) {
    const size_t off = (size_t)b * NT * c;
    cross_tail_body<T>(f, b, zero_attn, s, &bad);

    // ---- y = x1 + drop_path(gamma * dropout(fc2)) -------------------
    load_tile<T>(W2, static_cast<const T*>(a.d_y) + off, NT * c);
    __syncthreads();
    {
      const float m2 = drop_path_mul(d, DP2, b);
      float gacc = 0.f;
      for (int e = threadIdx.x; e < NT * c; e += blockDim.x) {
        float df = d.train ? W2[e] * m2 : W2[e];
        gacc = fmaf(df, z[e], gacc);
        if (d.stab_ccf) df *= gamma;
        W3[e] = drop(d, FFN, (unsigned)(b * NT * c + e), df);
      }
      if (d.stab_ccf) {
        block_sum(&gacc, 1, red, sums);
        if (threadIdx.x == 0) slice(g.gamma, a.c)[0] += sums[0];
      }
      __syncthreads();
    }
    // ---- fc2, post_dwconv_norm, scale, bias, dwconv, dwconv_norm ----
    dense_wgrad(pin, hc, 0, NT, hc, W3, c, c, 1, slice(g.fc2_w, a.c), c,
                slice(g.fc2_b, a.c));
    dense_dgrad<T>(W3, c, NT, c, f.fc2_w, c, hc, 1, 0, dH1, hc, false);
    __syncthreads();
    float* cur = dH1;
    float* oth = dH2;
    if (d.stab_ccf) {
      layer_norm_bwd_rows(dws, hc, cur, hc, oth, hc, false, NT, hc, f.pdn_s,
                          slice(g.pdn_s, a.c), slice(g.pdn_b, a.c), stats);
      float* t = cur; cur = oth; oth = t;
    }
    for (int ch = threadIdx.x; ch < hc; ch += blockDim.x) {
      if (d.stab_dw) {
        float gs = 0.f;
        for (int n = 0; n < NT; ++n)
          gs = fmaf(cur[n * hc + ch], dwb[n * hc + ch], gs);
        slice(g.dw_scale, a.c)[ch] += gs;
        const float sc_ch = rnd<T>(f.dw_scale[ch]);
        for (int n = 0; n < NT; ++n) cur[n * hc + ch] *= sc_ch;
      }
      if (d.dw_bias) {
        float gb = 0.f;
        for (int n = 0; n < NT; ++n) gb += cur[n * hc + ch];
        slice(g.dw_b, a.c)[ch] += gb;
      }
    }
    __syncthreads();
    {
      float* gw = slice(g.dw_w, a.c);
      for (int i = threadIdx.x; i < hc * 9; i += blockDim.x) {
        const int ch = i / 9, tap = i - ch * 9;
        const int ki = tap / 3, kj = tap - ki * 3;
        float acc = 0.f;
        for (int n = 0; n < NT; ++n) {
          const int si = n / 4 + ki - 1, sj = n % 4 + kj - 1;
          if (si >= 0 && si < 4 && sj >= 0 && sj < 4)
            acc = fmaf(cur[n * hc + ch], dwin[(si * 4 + sj) * hc + ch], acc);
        }
        gw[i] += acc;
      }
      for (int e = threadIdx.x; e < NT * hc; e += blockDim.x) {
        const int n = e / hc, ch = e - n * hc;
        const int si = n / 4, sj = n % 4;
        const float* k = f.dw_w + ch * 9;
        float acc = 0.f;
        for (int ki = 0; ki < 3; ++ki)
          for (int kj = 0; kj < 3; ++kj) {
            const int gi = si - ki + 1, gj = sj - kj + 1;
            if (gi >= 0 && gi < 4 && gj >= 0 && gj < 4)
              acc = fmaf(k[ki * 3 + kj], cur[(gi * 4 + gj) * hc + ch], acc);
          }
        oth[e] = acc;
      }
      __syncthreads();
      float* t = cur; cur = oth; oth = t;
    }
    if (d.stab_ccf) {
      layer_norm_bwd_rows(hg, hc, cur, hc, oth, hc, false, NT, hc, f.dwn_s,
                          slice(g.dwn_s, a.c), slice(g.dwn_b, a.c), stats);
      float* t = cur; cur = oth; oth = t;
    }
    for (int e = threadIdx.x; e < NT * hc; e += blockDim.x)
      cur[e] *= gelu_grad(h[e]);
    __syncthreads();
    // ---- fc1 and norm2: d(x1) = d(y) + norm2'(d(fin)) ----------------
    dense_wgrad(fin, c, 0, NT, c, cur, hc, hc, 1, slice(g.fc1_w, a.c), hc,
                slice(g.fc1_b, a.c));
    dense_dgrad<T>(cur, hc, NT, hc, f.fc1_w, hc, c, 1, 0, W1, c, false);
    __syncthreads();
    layer_norm_bwd_rows(x1, c, W1, c, W2, c, true, NT, c, f.norm2_s,
                        slice(g.norm2_s, a.c), slice(g.norm2_b, a.c), stats);
    store_tile<T>(static_cast<T*>(a.d_x) + off, W2, NT * c);
    // ---- x1 = x + drop_path(dropout(bottleneck)) ----------------------
    {
      const float m1 = drop_path_mul(d, DP1, b);
      for (int e = threadIdx.x; e < NT * c; e += blockDim.x)
        W3[e] = drop(d, BN2, (unsigned)(b * NT * c + e),
                     d.train ? W2[e] * m1 : W2[e]);
      __syncthreads();
    }
    dense_wgrad(g1, hb, 0, NT, hb, W3, c, c, 1, slice(g.bn2_w, a.c), c,
                slice(g.bn2_b, a.c));
    dense_dgrad<T>(W3, c, NT, c, f.bn2_w, c, hb, 1, 0, dH1, hb, false);
    __syncthreads();
    for (int e = threadIdx.x; e < NT * hb; e += blockDim.x)
      dH1[e] = drop(d, BN1, (unsigned)(b * NT * hb + e), dH1[e]) *
               gelu_grad(h1[e]);
    __syncthreads();
    dense_wgrad(fused, c, 0, NT, 4 * dc, dH1, hb, hb, 1, slice(g.bn1_w, a.c),
                hb, slice(g.bn1_b, a.c));
    dense_dgrad<T>(dH1, hb, NT, hb, f.bn1_w, hb, 4 * dc, 1, 0, W1, c, false);
    __syncthreads();
    // ---- the softmax fusion weights -----------------------------------
    {
      float w[4], v[4] = {0.f, 0.f, 0.f, 0.f};
      fusion_weights(f.fusion, w);
      for (int e = threadIdx.x; e < NT * c; e += blockDim.x) {
        const int i = (e % c) / dc;
        v[i] = fmaf(W1[e], cc[e], v[i]);
        W3[e] = W1[e] * w[i];
      }
      block_sum(v, 4, red, sums);
      if (threadIdx.x == 0) {
        float dot = 0.f;
        for (int i = 0; i < 4; ++i) dot = fmaf(w[i], sums[i], dot);
        float* gf = slice(g.fusion, a.c);
        for (int i = 0; i < 4; ++i) gf[i] += w[i] * (sums[i] - dot);
      }
      __syncthreads();
    }
    // ---- per branch: LN + compress ------------------------------------
    for (int i = 0; i < 4; ++i) {
      const float* src = X;
      if (i < 3) {
        load_tile<T>(W1, static_cast<const T*>(branch[i]) + off, NT * c);
        __syncthreads();
        src = W1;
      }
      layer_norm_rows<T>(src, c, W2, c, NT, c, f.norm_s[i], f.norm_b[i],
                         stats);
      dense_wgrad(W2, c, 0, NT, c, W3 + i * dc, c, dc, 1,
                  slice(g.comp_w[i], a.c), dc, slice(g.comp_b[i], a.c));
      __syncthreads();
      dense_dgrad<T>(W3 + i * dc, c, NT, dc, f.comp_w[i], dc, c, 1, 0, W2, c,
                     false);
      __syncthreads();
      float* dst = i < 3 ? fin : x1;
      layer_norm_bwd_rows(src, c, W2, c, dst, c, false, NT, c, f.norm_s[i],
                          slice(g.norm_s[i], a.c), slice(g.norm_b[i], a.c),
                          stats);
      if (i < 3) {
        store_tile<T>(static_cast<T*>(d_out3[i]) + off, fin, NT * c);
        __syncthreads();
      }
    }
    // ---- cross branch: proj dropout, proj, attention, K/V, q ----------
    drop_rows(d, CROSS_PROJ, (unsigned)(b * NT * c), x1, NT * c);
    __syncthreads();
    dense_wgrad(attc, c, 0, NT, c, x1, c, c, 1, slice(g.cp_w, a.c), c,
                slice(g.cp_b, a.c));
    dense_dgrad<T>(x1, c, NT, c, f.cp_w, c, c, 1, 0, z, c, false);
    __syncthreads();
    // a guarded branch passes zero gradient through its attention, so
    // nothing before it gets any
    if (zero_attn) {
      fill(W2, NT * c, 0.f);
      __syncthreads();
    } else {
      attention_bwd<T>(qc, c, NT, nh, c / nh, kb, vb, c, S, nullptr, nullptr,
                       c, 0, nh, z, c, sc, pr, dp, attn_drop(d, CROSS_ATTN),
                       (unsigned)b * nh * NT * S, qc, c, fused, cc, c, nullptr,
                       nullptr, c);
      dense_wgrad(a.c.bank_kr, c, 0, S, c, fused, c, c, 1, slice(g.ck_w, a.c),
                  c, slice(g.ck_b, a.c));
      dense_wgrad(a.c.bank_vr, c, 0, S, c, cc, c, c, 1, slice(g.cv_w, a.c), c,
                  slice(g.cv_b, a.c));
      dense_dgrad<T>(fused, c, S, c, f.ck_w, c, c, 1, 0, slice(g.bank_k, a.c),
                     c, true);
      dense_dgrad<T>(cc, c, S, c, f.cv_w, c, c, 1, 0, slice(g.bank_v, a.c), c,
                     true);
      load_tile<T>(W1, static_cast<const T*>(f.xn) + off, NT * c);
      __syncthreads();
      dense_wgrad(W1, c, 0, NT, c, qc, c, c, 1, slice(g.cq_w, a.c), c,
                  slice(g.cq_b, a.c));
      dense_dgrad<T>(qc, c, NT, c, f.cq_w, c, c, 1, 0, W2, c, false);
      __syncthreads();
    }
    store_tile<T>(static_cast<T*>(a.d_xn) + off, W2, NT * c);
    __syncthreads();
  }
}

}  // namespace qv

extern "C" int qv_unit_cross_tail_bwd(const qv::CrossTailBwdArgs* a,
                                      int is_bf16, void* stream) {
  const qv::Dims& d = a->f.d;
  const size_t smem = qv::cross_tail_bwd_smem_floats(d) * sizeof(float);
  const int rc =
      is_bf16 ? qv_launch(qv::cross_tail_bwd_kernel<qv::bf16>, *a, smem, stream,
                          d.grid)
              : qv_launch(qv::cross_tail_bwd_kernel<float>, *a, smem, stream,
                          d.grid);
  if (rc != 0) return rc;
  return qv_reduce(a->c.gws, a->c.grad, d.grid, a->c.wstride, d.rgrid, stream);
}

extern "C" int qv_unit_cross_tail_bwd_smem(const qv::Dims* d) {
  return qv::cross_tail_bwd_smem_floats(*d) * (int)sizeof(float);
}

extern "C" int qv_unit_cross_tail_bwd_scratch(const qv::Dims* d) {
  return qv::cross_tail_bwd_scratch_floats(*d);
}

// --- bf16 at hqavit_c100's widths: the tensor-core kernel --------------------

namespace qv {

struct CrossTailBwdMmaArgs {
  CrossTailBwdArgs a;     // the float32 kernel's arguments
  // bf16 w1 [C, CB_W1] | w2 [CB_HID, CB_W2] | w1^T | w2^T: w1 holds cq,
  // ck, cv, cp, compress_0..3, bottleneck fc1, CCF-FFN fc1 side by side
  // (C input rows each), w2 bottleneck fc2 and CCF-FFN fc2
  // (fused_kernels._cross_tail_packed)
  const bf16* w;
};

// the geometry cross_tail_bwd_mma_kernel is written for
// (fused_kernels.cross_tail_bwd_mma_error)
constexpr int CB_C = 192, CB_H = 4, CB_S = 16, CB_HID = 96, CB_DC = 48;
static_assert(CB_C / CB_H == ATT_D, "warp_attention's head width");
// column offsets in w1 and w2 (row offsets in their transposes)
constexpr int CB_CQ = 0, CB_CP = 3 * CB_C, CB_COMP = 4 * CB_C;
constexpr int CB_BN1 = CB_COMP + 4 * CB_DC, CB_FC1 = CB_BN1 + CB_HID;
constexpr int CB_W1 = CB_FC1 + CB_HID;
constexpr int CB_BN2 = 0, CB_FC2 = CB_C, CB_W2 = 2 * CB_C;
constexpr int CB_OW2 = CB_C * CB_W1, CB_OW1T = CB_OW2 + CB_HID * CB_W2;
constexpr int CB_OW2T = CB_OW1T + CB_W1 * CB_C;
// leading dims: 8 bf16 past the width (ldmatrix rows in distinct banks)
constexpr int CB_LDX = CB_C + 8, CB_LDH = CB_HID + 8;
constexpr int CB_X = PASS_ROWS * CB_LDX, CB_HB = PASS_ROWS * CB_LDH;
// columns of a block's saved operand rows (save_rows; wgrad_block's
// inputs): each weight gradient's input and its output's cotangent
constexpr int CB_OP_HP = 0, CB_OP_DZ = CB_OP_HP + CB_HID;
constexpr int CB_OP_FIN = CB_OP_DZ + CB_C, CB_OP_DH = CB_OP_FIN + CB_C;
constexpr int CB_OP_G1 = CB_OP_DH + CB_HID, CB_OP_DBN2 = CB_OP_G1 + CB_HID;
constexpr int CB_OP_FU = CB_OP_DBN2 + CB_C, CB_OP_DH1 = CB_OP_FU + CB_C;
constexpr int CB_OP_NRM = CB_OP_DH1 + CB_HID;       // the four branch LNs
constexpr int CB_OP_DCC = CB_OP_NRM + 4 * CB_C;
constexpr int CB_OP_ATT = CB_OP_DCC + CB_C, CB_OP_DX3 = CB_OP_ATT + CB_C;
constexpr int CB_OP_DQ = CB_OP_DX3 + CB_C, CB_OP_XN = CB_OP_DQ + CB_C;
constexpr int CB_OPW = CB_OP_XN + CB_C;
constexpr int CB_RING = 3 * RING_KS * CB_LDX;
static_assert(CB_DC * CB_LDX <= CB_RING, "a compress^T staged in the ring");
constexpr int CB_BF16 = 2 * CB_S * CB_LDX + 10 * CB_X + 6 * CB_HB + CB_RING;
constexpr int CB_SMEM_BYTES = 2 * CB_BF16 + (4 * PASS_ROWS + 9 * 4) * 4;
static_assert(2 * 2 * CB_S * CB_C * 4 <= 2 * 10 * CB_X,
              "the bank cotangents fit in the X buffers");

// n = 64: the partner's grid row next to the CTA's own, [8, HID] bf16:
// the dwconv's input, then the cotangent of its output
constexpr int CB_HALO = 8 * CB_LDH;
constexpr int CB64_SMEM_BYTES = CB_SMEM_BYTES + 2 * CB_HALO * 2;
// n = 64: the float32 sums a CTA keeps over its passes (CA_* offsets),
// the slice fields they end in summed over the pair
constexpr int CA_GAMMA = 0, CA_FUSION = 4, CA_PDN = 8;
constexpr int CA_DWS = CA_PDN + 2 * CB_HID, CA_DWB = CA_DWS + CB_HID;
constexpr int CA_DWW = CA_DWB + CB_HID, CA_DWN = CA_DWW + 9 * CB_HID;
constexpr int CA_NORM2 = CA_DWN + 2 * CB_HID, CA_NORM = CA_NORM2 + 2 * CB_C;
constexpr int CA_N = CA_NORM + 4 * 2 * CB_C;
constexpr int CB_DKV = 2 * CB_S * CB_C;   // the bank K/V cotangents' sums
static_assert((CB_DKV + CA_N) % 4 == 0, "16-byte aligned operand rows");

// n = 16, per block: the bank K/V projections' cotangents (float32), the
// operand rows (bf16) of its passes of 32 rows.  n = 64, per cluster:
// each CTA's bank cotangents and CA_N sums, then the operand rows of the
// cluster's passes, two a sample (CTA rank h's of the k-th at pass 2k+h)
__host__ __device__ inline int cross_tail_bwd_mma_scratch_floats(
    const Dims& d) {
  const int nb = (d.B + d.grid - 1) / d.grid;
  if (d.n == NT) return CB_DKV + PASS_ROWS * ((nb + 1) / 2) * CB_OPW / 2;
  return 2 * (CB_DKV + CA_N) + PASS_ROWS * 2 * nb * CB_OPW / 2;
}

// Passes of 32 rows.  n = 16 (SIDE 4, cross_tail_bwd_mma_kernel): one
// block per SM walks its samples two a pass (an odd last pass runs a
// sample of zeros with a zero cotangent, which adds nothing), its sums in
// its own slice.  n = 64 (SIDE 8, cross_tail_bwd_mma64_kernel, PAIR): a
// cluster of two CTAs walks its samples, CTA rank h half h of each (grid
// rows 4h..4h+3) in one pass; the dwconv's halo row is the partner's,
// read once it is written (a cluster barrier after the dwconv's input and
// after its output's cotangent) and before the partner overwrites it (the
// partner's arrival after its read, waited for before the bottleneck's
// backward rewrites that buffer); the CTA's scalar and LayerNorm sums go
// to its own scratch (CA_*), and at the end the pair sums them and forms
// the weight gradients into the cluster's slice.  The [32, C] buffers
// of a pass:
//   q     cross q                     att  cross attention; then P used
//   x3    cross output (branch 3)     cc   compressed branches; cga LN
//   fu    fused concat; cross LN      x1   x, x1; then LN cotangents
//   dy    d(y); then d(att)           w1b  xn, norm2(x1), branches, dq
//   w2b   swa LN, then d(fc2 out), d(bottleneck out), d(fused), d(cc)
//   w3b   msda LN; then d(fin), d(x1); branch LN; dS
// and the [32, 96] ones: h1 bottleneck hidden before GELU, hh CCF hidden
// before GELU, dwb the dwconv output before its scale, ha hb hc in turn.
// The operand rows of the weight gradients go to the scratch (CB_OP_*).
template <int SIDE>
__device__ __forceinline__ void cross_tail_bwd_mma(
    const CrossTailBwdMmaArgs& m) {
  constexpr int SN = SIDE * SIDE;          // tokens of a sample
  constexpr bool PAIR = SIDE != WS;        // a two-CTA cluster a sample
  QV_SMEM_DECL
  QV_STAMP(cross_tail_bwd, -1);
  const CrossTailBwdArgs& a = m.a;
  const CrossTailArgs& f = a.f;
  const Dims& d = f.d;
  const CrossTailGrads& gr = a.g;
  const int S = d.bank_s, C = CB_C, HID = CB_HID;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // the CTA's rank in its cluster; the slice's (and scratch's) index and
  // their count: the block's, or the cluster's
  int rank = 0;
  if constexpr (PAIR) rank = (int)cluster_rank();
  const int unit = PAIR ? (int)blockIdx.x / 2 : (int)blockIdx.x;
  const int units = PAIR ? (int)gridDim.x / 2 : (int)gridDim.x;
  auto sl = [&](float* p) {
    return p == nullptr ? p : p + (size_t)unit * a.c.wstride;
  };
  bf16* kb = reinterpret_cast<bf16*>(qv_smem);
  bf16* vb = kb + CB_S * CB_LDX;
  bf16* q = vb + CB_S * CB_LDX;
  bf16* att = q + CB_X;
  bf16* x3 = att + CB_X;
  bf16* cc = x3 + CB_X;
  bf16* fu = cc + CB_X;
  bf16* x1 = fu + CB_X;
  bf16* dy = x1 + CB_X;
  bf16* w1b = dy + CB_X;
  bf16* w2b = w1b + CB_X;
  bf16* w3b = w2b + CB_X;
  bf16* h1 = w3b + CB_X;
  bf16* hh = h1 + CB_HB;
  bf16* dwb = hh + CB_HB;
  bf16* ha = dwb + CB_HB;
  bf16* hb = ha + CB_HB;
  bf16* hc = hb + CB_HB;
  bf16* ring = hc + CB_HB;
  float* stats = reinterpret_cast<float*>(ring + CB_RING);  // [32][4]
  float* red = stats + 4 * PASS_ROWS;                         // 9 x 4
  bf16* hbh = reinterpret_cast<bf16*>(red + 9 * 4);           // n = 64
  bf16* hah = hbh + CB_HALO;
  const bf16* w1 = m.w;
  const bf16* w2 = m.w + CB_OW2;
  const bf16* w1t = m.w + CB_OW1T;
  const bf16* w2t = m.w + CB_OW2T;
  const bf16 zero = from_f<bf16>(0.f);
  const bool zero_attn = d.guard && a.c.flag[1] != 0;
  float* scr = a.c.scratch + (size_t)unit *
                                 cross_tail_bwd_mma_scratch_floats(d);
  // the bank cotangents' sums; n = 64: the CTA's, then its CA_* sums
  float* dkv = scr + rank * (CB_DKV + CA_N);
  float* cacc = dkv + CB_DKV;
  bf16* ops = reinterpret_cast<bf16*>(scr + (PAIR ? 2 * (CB_DKV + CA_N)
                                                  : CB_DKV));
  // where a per-pass sum goes: the block's slice (n = 16, zeroed by the
  // caller), or the CTA's CA_* sums at offset `off`
  auto sums = [&](float* field, int off) {
    if constexpr (PAIR) return cacc + off;
    return sl(field);
  };
  // a dropout mask's kept value: the quotient by keep, as the plain
  // version (n = 16), or the product with 1 / keep (n = 64: within an ulp
  // of it, and no IEEE division an element)
  const float inv_keep = 1.f / d.keep;
  auto drp = [&](int key, unsigned idx, float v) {
    if constexpr (PAIR) return drop_r(d, key, idx, v, inv_keep);
    return drop(d, key, idx, v);
  };
  float fw[4];
  fusion_weights(f.fusion, fw);
  const float gamma = f.gamma[0];
  auto gelu_r = [](const bf16* p) {
    return rnd<bf16>(gelu_f(to_f<bf16>(*p)));
  };
  auto put = [](bf16* p, float v0, float v1) {
    store_bf16x2(p, pack_bf16x2(v0, v1));
  };

  // per block: the bank's K/V projections (rows past S zero) through the
  // ring, k rows 0-15 and v rows 16-31 of q as their input; the bank
  // cotangents' scratch zeroed
  for (int i = threadIdx.x; i < PASS_ROWS * C; i += blockDim.x) {
    const int r = i / C, c = i - r * C, rr = r & 15;
    const float* src = r < CB_S ? f.bank_k : f.bank_v;
    q[r * CB_LDX + c] = from_f<bf16>(rr < S ? rnd<bf16>(src[rr * C + c])
                                            : 0.f);
  }
  for (int i = threadIdx.x; i < (PAIR ? CB_DKV + CA_N : CB_DKV);
       i += blockDim.x)
    dkv[i] = 0.f;
  __syncthreads();
  for (int w = 0; w < 2; ++w)
    gemm_pass<192, 3>(q, CB_LDX, w1 + (1 + w) * C, CB_W1, C, ring,
                      [&](int r, int c, float v0, float v1) {
                        if ((r >> 4) != w) return;
                        const float* b = w ? f.cv_b : f.ck_b;
                        const bool in = (r & 15) < S;
                        put((w ? vb : kb) + (r & 15) * CB_LDX + c,
                            in ? dense_out(v0, b[c]) : 0.f,
                            in ? dense_out(v1, b[c + 1]) : 0.f);
                      });
  QV_STAMP(cross_tail_bwd, 0);

  // the partner's grid row next to this CTA's half of src (its rows 0-7
  // for rank 0, 24-31 for rank 1) into dst; block-wide, no barrier
  auto halo = [&](bf16* dst, const bf16* src) {
    const bf16* peer = cluster_peer(src + (rank ? PASS_ROWS - SIDE : 0) *
                                              CB_LDH, (unsigned)rank ^ 1u);
    for (int i = threadIdx.x; i < SIDE * (HID / 8); i += blockDim.x) {
      const int r = i / (HID / 8), c = (i - r * (HID / 8)) * 8;
      *reinterpret_cast<uint4*>(dst + r * CB_LDH + c) =
          *reinterpret_cast<const uint4*>(peer + r * CB_LDH + c);
    }
  };

  // Pass pi (its operand rows): at n = 16 the samples bs[0], bs[1] (the
  // first ns of them), at n = 64 the CTA's half of sample bs[0] (= bs[1]).
  auto pass = [&](int pi, const int (&bs)[2], int ns) {
    bf16* op = ops + (size_t)pi * PASS_ROWS * CB_OPW;  // pass's rows
    // the flat token index of the pass's row r (the samples by a select:
    // an index into bs would go to memory), and of (r, column c) in a
    // [B, n, width] mask; whether row r holds a sample's
    auto tok = [&](int r) {
      if constexpr (PAIR) return bs[0] * SN + PASS_ROWS * rank + r;
      return (r >> 4 ? bs[1] : bs[0]) * NT + (r & 15);
    };
    auto idx = [&](int r, int c, int width) {
      return (unsigned)(tok(r) * width + c);
    };
    auto valid = [&](int r) { return SIDE != WS || (r >> 4) < ns; };
    // the pass's rows of src, zeros past its samples
    auto stage = [&](bf16* dst, const void* src) {
      for (int i = threadIdx.x; i < PASS_ROWS * (C / 8); i += blockDim.x) {
        const int r = i / (C / 8), c = (i - r * (C / 8)) * 8;
        bf16* to = dst + r * CB_LDX + c;
        if (valid(r))
          cp_async_16(to, static_cast<const bf16*>(src) + (size_t)tok(r) * C +
                              c);
        else
          *reinterpret_cast<uint4*>(to) = uint4{0u, 0u, 0u, 0u};
      }
    };
    // the pass's sample rows of src (zeros if src is null) to dst, 16
    // bytes a copy
    auto store_rows = [&](void* dst, const bf16* src) {
      for (int i = threadIdx.x; i < PASS_ROWS * (C / 8); i += blockDim.x) {
        const int r = i / (C / 8), c = (i - r * (C / 8)) * 8;
        if (!valid(r)) continue;
        *reinterpret_cast<uint4*>(static_cast<bf16*>(dst) +
                                  (size_t)tok(r) * C + c) =
            src ? *reinterpret_cast<const uint4*>(src + r * CB_LDX + c)
                : uint4{0u, 0u, 0u, 0u};
      }
    };
    // the grid position of row r in its sample; the dwconv's input and
    // its output's cotangent at (si, sj) of row r's sample (n = 64: a row
    // of the other half is the halo row)
    auto grid_pos = [&](int r) {
      return PAIR ? PASS_ROWS * rank + r : (r & 15);
    };
    auto at = [&](const bf16* own, const bf16* hal, int r, int si, int sj,
                  int ch) {
      if constexpr (PAIR) {
        const int n = si * SIDE + sj - PASS_ROWS * rank;
        return to_f<bf16>(n >= 0 && n < PASS_ROWS ? own[n * CB_LDH + ch]
                                                  : hal[sj * CB_LDH + ch]);
      }
      return to_f<bf16>(own[((r & ~15) + si * WS + sj) * CB_LDH + ch]);
    };
    auto hb_at = [&](int r, int si, int sj, int ch) {
      return at(hb, hbh, r, si, sj, ch);
    };
    auto ha_at = [&](int r, int si, int sj, int ch) {
      return at(ha, hah, r, si, sj, ch);
    };
    const float m1a = drop_path_mul(d, DP1, bs[0]);
    const float m1b = drop_path_mul(d, DP1, bs[1]);
    const float m2a = drop_path_mul(d, DP2, bs[0]);
    const float m2b = drop_path_mul(d, DP2, bs[1]);
    auto m1 = [&](int r) { return r >> 4 ? m1b : m1a; };
    auto m2 = [&](int r) { return r >> 4 ? m2b : m2a; };
    stage(w1b, f.xn);
    stage(x1, f.x);
    stage(w2b, f.swa);
    stage(w3b, f.msda);
    stage(cc, f.cga);
    stage(dy, a.d_y);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    QV_STAMP(cross_tail_bwd, 1);

    // ---- recompute: the cross branch -----------------------------------
    gemm_pass<192, 3>(w1b, CB_LDX, w1 + CB_CQ, CB_W1, C, ring,
                      [&](int r, int c, float v0, float v1) {
                        put(q + r * CB_LDX + c, dense_out(v0, f.cq_b[c]),
                            dense_out(v1, f.cq_b[c + 1]));
                      });
    __syncthreads();
    const int s = warp >> 2, h = warp & 3, hcol = h * ATT_D;
    // the mask of the warp's sample [H, SN, S] from its rows' first
    const int bw = s ? bs[1] : bs[0];
    const AttnMask am{attn_drop(d, CROSS_ATTN),
                      (unsigned)(bw * CB_H * SN + tok(16 * s) - bw * SN) * S,
                      h, S, SN};
    const bf16* const kt[1] = {kb};
    const bf16* const vt[1] = {vb};
    unsigned qa[3][4];
#pragma unroll
    for (int ks = 0; ks < 3; ++ks)
      load_a(qa[ks], q + 16 * s * CB_LDX + hcol + 16 * ks, CB_LDX, lane);
    if (zero_attn) {
      for (int i = threadIdx.x; i < CB_X; i += blockDim.x) att[i] = zero;
    } else {
      warp_attention_train<1>(qa, kt, vt, CB_LDX, hcol, S, am,
                              att + 16 * s * CB_LDX, CB_LDX);
    }
    __syncthreads();
    gemm_pass<192, 3>(att, CB_LDX, w1 + CB_CP, CB_W1, C, ring,
                      [&](int r, int c, float v0, float v1) {
                        put(x3 + r * CB_LDX + c,
                            rnd<bf16>(drp(CROSS_PROJ, idx(r, c, C),
                                           dense_out(v0, f.cp_b[c]))),
                            rnd<bf16>(drp(CROSS_PROJ, idx(r, c + 1, C),
                                           dense_out(v1, f.cp_b[c + 1]))));
                      });
    __syncthreads();
    // ---- the tail: LN + compress of the four branches, fusion -----------
    ln_rows<PASS_ROWS, CB_C>(w2b, w2b, CB_LDX, f.norm_s[0], f.norm_b[0]);
    ln_rows<PASS_ROWS, CB_C>(w3b, w3b, CB_LDX, f.norm_s[1], f.norm_b[1]);
    ln_rows<PASS_ROWS, CB_C>(cc, cc, CB_LDX, f.norm_s[2], f.norm_b[2]);
    ln_rows<PASS_ROWS, CB_C>(x3, fu, CB_LDX, f.norm_s[3], f.norm_b[3]);
    __syncthreads();
    {  // warp (branch i, 16 rows): its 48 columns of the concat
      const int i = warp >> 1, mt = warp & 1, g = lane >> 2, t = lane & 3;
      const bf16* br[4] = {w2b, w3b, cc, fu};
      float acc[1][6][4];
      ring_gemm<1, 6, 3>(br[i] + mt * 16 * CB_LDX, CB_LDX, w1 + CB_COMP,
                         CB_W1, C, C, ring, CB_LDX, CB_DC * i, acc);
#pragma unroll
      for (int j = 0; j < 6; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = 16 * mt + g + 8 * hf, c = 8 * j + 2 * t;
          const float v0 = dense_out(acc[0][j][2 * hf], f.comp_b[i][c]);
          const float v1 = dense_out(acc[0][j][2 * hf + 1],
                                     f.comp_b[i][c + 1]);
          put(cc + r * CB_LDX + CB_DC * i + c, v0, v1);
          put(fu + r * CB_LDX + CB_DC * i + c, rnd<bf16>(v0 * fw[i]),
              rnd<bf16>(v1 * fw[i]));
        }
    }
    __syncthreads();
    // ---- bottleneck MLP, drop-path, the first residual -------------------
    gemm_pass<96, 3>(fu, CB_LDX, w1 + CB_BN1, CB_W1, C, ring,
                     [&](int r, int c, float v0, float v1) {
                       put(h1 + r * CB_LDH + c, dense_out(v0, f.bn1_b[c]),
                           dense_out(v1, f.bn1_b[c + 1]));
                     });
    __syncthreads();
    auto g1 = [&](int r, int c) {     // dropout(GELU(h1)), as the forward
      return rnd<bf16>(drp(BN1, idx(r, c, HID),
                            gelu_r(h1 + r * CB_LDH + c)));
    };
    for (int i = threadIdx.x; i < PASS_ROWS * HID / 2; i += blockDim.x) {
      const int r = i / (HID / 2), c = 2 * (i - r * (HID / 2));
      put(ha + r * CB_LDH + c, g1(r, c), g1(r, c + 1));
    }
    __syncthreads();
    gemm_pass<192, 3>(ha, CB_LDH, w2 + CB_BN2, CB_W2, HID, ring,
                      [&](int r, int c, float v0, float v1) {
                        float v[2] = {v0, v1};
                        bf16* p = x1 + r * CB_LDX + c;
#pragma unroll
                        for (int e = 0; e < 2; ++e) {
                          float y = rnd<bf16>(drp(
                              BN2, idx(r, c + e, C),
                              dense_out(v[e], f.bn2_b[c + e])));
                          if (d.train) y = rnd<bf16>(y * m1(r));
                          v[e] = to_f<bf16>(p[e]) + y;
                        }
                        put(p, v[0], v[1]);
                      });
    __syncthreads();
    // ---- CCF-FFN -----------------------------------------------------------
    ln_rows<PASS_ROWS, CB_C>(x1, w1b, CB_LDX, f.norm2_s, f.norm2_b);
    __syncthreads();
    gemm_pass<96, 3>(w1b, CB_LDX, w1 + CB_FC1, CB_W1, C, ring,
                     [&](int r, int c, float v0, float v1) {
                       put(hh + r * CB_LDH + c, dense_out(v0, f.fc1_b[c]),
                           dense_out(v1, f.fc1_b[c + 1]));
                     });
    __syncthreads();
    for (int i = threadIdx.x; i < PASS_ROWS * HID; i += blockDim.x) {
      const int r = i / HID, c = i - r * HID;
      ha[r * CB_LDH + c] = from_f<bf16>(gelu_r(hh + r * CB_LDH + c));
    }
    __syncthreads();
    ln_rows<PASS_ROWS, CB_HID>(ha, hb, CB_LDH, f.dwn_s, f.dwn_b);
    __syncthreads();
    if constexpr (PAIR) {     // the partner's dwconv input next to ours
      QV_STAMP(cross_tail_bwd, 2);
      cluster_sync();
      QV_STAMP(cross_tail_bwd, 11);
      halo(hbh, hb);
      __syncthreads();
    }
    QV_STAMP(cross_tail_bwd, 2);
    // the 3x3 depthwise correlation on each sample's grid (zero halo,
    // bias before the scale), as ccf_dwconv
    for (int i = threadIdx.x; i < PASS_ROWS * HID; i += blockDim.x) {
      const int r = i / HID, ch = i - r * HID, n = grid_pos(r);
      const int gi = n / SIDE, gj = n % SIDE;
      float acc = 0.f;
      for (int ki = 0; ki < 3; ++ki)
        for (int kj = 0; kj < 3; ++kj) {
          const int si = gi + ki - 1, sj = gj + kj - 1;
          const float v = (si >= 0 && si < SIDE && sj >= 0 && sj < SIDE)
                              ? hb_at(r, si, sj, ch)
                              : 0.f;
          acc = fmaf(v, f.dw_w[ch * 9 + ki * 3 + kj], acc);
        }
      float yv = rnd<bf16>(acc);
      if (d.dw_bias) yv = rnd<bf16>(yv + rnd<bf16>(f.dw_b[ch]));
      dwb[r * CB_LDH + ch] = from_f<bf16>(yv);
      hc[r * CB_LDH + ch] =
          from_f<bf16>(rnd<bf16>(yv * rnd<bf16>(f.dw_scale[ch])));
    }
    __syncthreads();
    ln_rows<PASS_ROWS, CB_HID>(hc, hc, CB_LDH, f.pdn_s, f.pdn_b);
    __syncthreads();
    {  // fc2 and its dropout; gamma's gradient sum(d(y) m2 z) on the way
      float gacc[1] = {0.f};
      gemm_pass<192, 3>(hc, CB_LDH, w2 + CB_FC2, CB_W2, HID, ring,
                        [&](int r, int c, float v0, float v1) {
                          const float v[2] = {v0, v1};
#pragma unroll
                          for (int e = 0; e < 2; ++e) {
                            const float z = rnd<bf16>(drp(
                                FFN, idx(r, c + e, C),
                                dense_out(v[e], f.fc2_b[c + e])));
                            float df = to_f<bf16>(dy[r * CB_LDX + c + e]);
                            if (d.train) df *= m2(r);
                            gacc[0] = fmaf(df, z, gacc[0]);
                          }
                        });
      block_sums<1>(gacc, red);
      if (threadIdx.x == 0) sums(gr.gamma, CA_GAMMA)[0] += red[8];
    }
    QV_STAMP(cross_tail_bwd, 3);

    // ---- backward: gamma, fc2, post-dwconv LN, scale, dwconv ------------
    for (int i = threadIdx.x; i < PASS_ROWS * C / 2; i += blockDim.x) {
      const int r = i / (C / 2), c = 2 * (i - r * (C / 2));
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float df = to_f<bf16>(dy[r * CB_LDX + c + e]);
        if (d.train) df *= m2(r);
        v[e] = drp(FFN, idx(r, c + e, C), df * gamma);
      }
      put(w2b + r * CB_LDX + c, v[0], v[1]);
    }
    __syncthreads();
    save_rows(op + CB_OP_HP, CB_OPW, hc, CB_LDH, HID);
    save_rows(op + CB_OP_DZ, CB_OPW, w2b, CB_LDX, C);
    gemm_pass<96, 3>(w2b, CB_LDX, w2t + CB_FC2 * HID, HID, C, ring,
                     [&](int r, int c, float v0, float v1) {
                       put(ha + r * CB_LDH + c, v0, v1);
                     });
    __syncthreads();
    for (int i = threadIdx.x; i < PASS_ROWS * HID; i += blockDim.x) {
      const int r = i / HID, ch = i - r * HID;    // dws, the LN's input
      hc[r * CB_LDH + ch] = from_f<bf16>(rnd<bf16>(
          to_f<bf16>(dwb[r * CB_LDH + ch]) * rnd<bf16>(f.dw_scale[ch])));
    }
    __syncthreads();
    ln_bwd_rows<PASS_ROWS, CB_HID>(hc, ha, ha, nullptr, CB_LDH, f.pdn_s,
                                   sums(gr.pdn_s, CA_PDN),
                                   sums(gr.pdn_b, CA_PDN + HID), stats);
    for (int ch = threadIdx.x; ch < HID; ch += blockDim.x) {
      const float sc = rnd<bf16>(f.dw_scale[ch]);
      float gs = 0.f, gbias = 0.f;
      for (int r = 0; r < PASS_ROWS; ++r) {
        bf16* p = ha + r * CB_LDH + ch;
        const float v = to_f<bf16>(*p);
        gs = fmaf(v, to_f<bf16>(dwb[r * CB_LDH + ch]), gs);
        *p = from_f<bf16>(v * sc);
        gbias += to_f<bf16>(*p);
      }
      sums(gr.dw_scale, CA_DWS)[ch] += gs;
      if (d.dw_bias) sums(gr.dw_b, CA_DWB)[ch] += gbias;
    }
    __syncthreads();
    if constexpr (PAIR) {     // the partner's cotangent next to ours
      QV_STAMP(cross_tail_bwd, 4);
      cluster_sync();
      QV_STAMP(cross_tail_bwd, 11);
      halo(hah, ha);
      __syncthreads();
      cluster_arrive();       // our reads of the partner's rows are done
    }
    QV_STAMP(cross_tail_bwd, 4);
    {  // the dwconv's weights (from its input) and its input
      float* gw = sums(gr.dw_w, CA_DWW);
      for (int i = threadIdx.x; i < HID * 9; i += blockDim.x) {
        const int ch = i / 9, tap = i - ch * 9, ki = tap / 3, kj = tap % 3;
        float acc = 0.f;
        for (int r = 0; r < PASS_ROWS; ++r) {
          const int n = grid_pos(r), si = n / SIDE + ki - 1;
          const int sj = n % SIDE + kj - 1;
          if (si >= 0 && si < SIDE && sj >= 0 && sj < SIDE)
            acc = fmaf(ha_at(r, n / SIDE, n % SIDE, ch),
                       hb_at(r, si, sj, ch), acc);
        }
        gw[i] += acc;
      }
      for (int i = threadIdx.x; i < PASS_ROWS * HID; i += blockDim.x) {
        const int r = i / HID, ch = i - r * HID, n = grid_pos(r);
        const int si = n / SIDE, sj = n % SIDE;
        float acc = 0.f;
        for (int ki = 0; ki < 3; ++ki)
          for (int kj = 0; kj < 3; ++kj) {
            const int gi = si - ki + 1, gj = sj - kj + 1;
            if (gi >= 0 && gi < SIDE && gj >= 0 && gj < SIDE)
              acc = fmaf(f.dw_w[ch * 9 + ki * 3 + kj], ha_at(r, gi, gj, ch),
                         acc);
          }
        hc[r * CB_LDH + ch] = from_f<bf16>(acc);
      }
    }
    __syncthreads();
    // ---- dwconv LN, GELU, fc1, norm2 ----------------------------------
    for (int i = threadIdx.x; i < PASS_ROWS * HID; i += blockDim.x) {
      const int r = i / HID, c = i - r * HID;     // the GELU, the LN's input
      hb[r * CB_LDH + c] = from_f<bf16>(gelu_r(hh + r * CB_LDH + c));
    }
    __syncthreads();
    ln_bwd_rows<PASS_ROWS, CB_HID>(hb, hc, hc, nullptr, CB_LDH, f.dwn_s,
                                   sums(gr.dwn_s, CA_DWN),
                                   sums(gr.dwn_b, CA_DWN + HID), stats);
    for (int i = threadIdx.x; i < PASS_ROWS * HID; i += blockDim.x) {
      const int r = i / HID, c = i - r * HID;
      bf16* p = hc + r * CB_LDH + c;
      *p = from_f<bf16>(to_f<bf16>(*p) *
                        gelu_grad(to_f<bf16>(hh[r * CB_LDH + c])));
    }
    __syncthreads();
    save_rows(op + CB_OP_FIN, CB_OPW, w1b, CB_LDX, C);
    save_rows(op + CB_OP_DH, CB_OPW, hc, CB_LDH, HID);
    gemm_pass<192, 3>(hc, CB_LDH, w1t + CB_FC1 * C, C, HID, ring,
                      [&](int r, int c, float v0, float v1) {
                        put(w3b + r * CB_LDX + c, v0, v1);
                      });
    __syncthreads();
    // d(x1) = d(y) + norm2'(d(fin)); it is d(x)
    ln_bwd_rows<PASS_ROWS, CB_C>(x1, w3b, w3b, dy, CB_LDX, f.norm2_s,
                                 sums(gr.norm2_s, CA_NORM2),
                                 sums(gr.norm2_b, CA_NORM2 + C), stats);
    store_rows(a.d_x, w3b);
    QV_STAMP(cross_tail_bwd, 5);
    // ---- drop-path, bottleneck bn2 and bn1 --------------------------------
    for (int i = threadIdx.x; i < PASS_ROWS * C / 2; i += blockDim.x) {
      const int r = i / (C / 2), c = 2 * (i - r * (C / 2));
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float dv = to_f<bf16>(w3b[r * CB_LDX + c + e]);
        if (d.train) dv *= m1(r);
        v[e] = drp(BN2, idx(r, c + e, C), dv);
      }
      put(w2b + r * CB_LDX + c, v[0], v[1]);
    }
    if constexpr (PAIR) {     // the partner has read our ha
      QV_STAMP(cross_tail_bwd, 6);
      cluster_wait();
      QV_STAMP(cross_tail_bwd, 11);
    }
    for (int i = threadIdx.x; i < PASS_ROWS * HID / 2; i += blockDim.x) {
      const int r = i / (HID / 2), c = 2 * (i - r * (HID / 2));
      put(ha + r * CB_LDH + c, g1(r, c), g1(r, c + 1));
    }
    __syncthreads();
    save_rows(op + CB_OP_G1, CB_OPW, ha, CB_LDH, HID);
    save_rows(op + CB_OP_DBN2, CB_OPW, w2b, CB_LDX, C);
    gemm_pass<96, 3>(w2b, CB_LDX, w2t + CB_BN2 * HID, HID, C, ring,
                     [&](int r, int c, float v0, float v1) {
                       const float v[2] = {v0, v1};
                       float o[2];
#pragma unroll
                       for (int e = 0; e < 2; ++e)
                         o[e] = drp(BN1, idx(r, c + e, HID), v[e]) *
                                gelu_grad(to_f<bf16>(h1[r * CB_LDH + c + e]));
                       put(hb + r * CB_LDH + c, o[0], o[1]);
                     });
    __syncthreads();
    save_rows(op + CB_OP_FU, CB_OPW, fu, CB_LDX, C);
    save_rows(op + CB_OP_DH1, CB_OPW, hb, CB_LDH, HID);
    gemm_pass<192, 3>(hb, CB_LDH, w1t + CB_BN1 * C, C, HID, ring,
                      [&](int r, int c, float v0, float v1) {
                        put(w2b + r * CB_LDX + c, v0, v1);
                      });
    __syncthreads();
    {  // the softmax fusion weights; d(cc) = d(fused) w in place
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      for (int i = threadIdx.x; i < PASS_ROWS * C; i += blockDim.x) {
        const int r = i / C, c = i - r * C, br = c / CB_DC;
        bf16* p = w2b + r * CB_LDX + c;
        const float dfu = to_f<bf16>(*p);
        v[br] = fmaf(dfu, to_f<bf16>(cc[r * CB_LDX + c]), v[br]);
        *p = from_f<bf16>(dfu * fw[br]);
      }
      block_sums<4>(v, red);
      if (threadIdx.x == 0) {
        float dot = 0.f;
        for (int i = 0; i < 4; ++i) dot = fmaf(fw[i], red[32 + i], dot);
        float* gf = sums(gr.fusion, CA_FUSION);
        for (int i = 0; i < 4; ++i) gf[i] += fw[i] * (red[32 + i] - dot);
      }
    }
    QV_STAMP(cross_tail_bwd, 6);
    // ---- per branch: LN + compress ----------------------------------------
    void* d_out3[3] = {a.d_swa, a.d_msda, a.d_cga};
    const void* branch[3] = {f.swa, f.msda, f.cga};
    for (int i = 0; i < 4; ++i) {
      const bf16* src = i < 3 ? w1b : x3;
      if (i < 3) stage(w1b, branch[i]);
      // compress_i^T [48, C] into the ring
      for (int k = threadIdx.x; k < CB_DC * (C / 8); k += blockDim.x) {
        const int r = k / (C / 8), c = (k - r * (C / 8)) * 8;
        cp_async_16(ring + r * CB_LDX + c,
                    w1t + (size_t)(CB_COMP + CB_DC * i + r) * C + c);
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      ln_rows<PASS_ROWS, CB_C>(src, w3b, CB_LDX, f.norm_s[i], f.norm_b[i]);
      __syncthreads();
      save_rows(op + CB_OP_NRM + C * i, CB_OPW, w3b, CB_LDX, C);
      if (i == 0) save_rows(op + CB_OP_DCC, CB_OPW, w2b, CB_LDX, C);
      gemm_pass_smem(w2b + CB_DC * i, CB_LDX, ring, CB_LDX, CB_DC,
                     [&](int r, int c, float v0, float v1) {
                       put(x1 + r * CB_LDX + c, v0, v1);
                     });
      __syncthreads();
      ln_bwd_rows<PASS_ROWS, CB_C>(
          src, x1, x1, nullptr, CB_LDX, f.norm_s[i],
          sums(gr.norm_s[i], CA_NORM + 2 * C * i),
          sums(gr.norm_b[i], CA_NORM + 2 * C * i + C), stats);
      if (i < 3) {
        store_rows(d_out3[i], x1);
        __syncthreads();
      }
    }
    QV_STAMP(cross_tail_bwd, 7);
    // ---- the cross branch: proj dropout, proj -------------------------------
    for (int i = threadIdx.x; i < PASS_ROWS * C; i += blockDim.x) {
      const int r = i / C, c = i - r * C;
      bf16* p = x1 + r * CB_LDX + c;
      *p = from_f<bf16>(drp(CROSS_PROJ, idx(r, c, C), to_f<bf16>(*p)));
    }
    __syncthreads();
    save_rows(op + CB_OP_ATT, CB_OPW, att, CB_LDX, C);
    save_rows(op + CB_OP_DX3, CB_OPW, x1, CB_LDX, C);
    if (zero_attn) {
      // a guarded branch passes zero gradient through its attention, so
      // nothing before it gets any
      store_rows(a.d_xn, nullptr);
      __syncthreads();
      return;
    }
    gemm_pass<192, 3>(x1, CB_LDX, w1t + CB_CP * C, C, C, ring,
                      [&](int r, int c, float v0, float v1) {
                        put(dy + r * CB_LDX + c, v0, v1);
                      });
    __syncthreads();
    // ---- attention: dq to w1b, dS to w3b, P to att (16 keys a head) -----
#pragma unroll
    for (int ks = 0; ks < 3; ++ks)
      load_a(qa[ks], q + 16 * s * CB_LDX + hcol + 16 * ks, CB_LDX, lane);
    warp_attention_bwd<1>(qa, kt, vt, CB_LDX, hcol, S, am,
                          dy + 16 * s * CB_LDX, CB_LDX,
                          w1b + 16 * s * CB_LDX, CB_LDX,
                          w3b + 16 * s * CB_LDX + 16 * h,
                          att + 16 * s * CB_LDX + 16 * h, CB_LDX);
    __syncthreads();
    stage(x1, f.xn);
    cp_async_commit();
    {  // the projected bank keys: warp (k or v, head), summed over the
       // pass's rows into the scratch
      const int w = warp >> 2, hb2 = (warp & 3) * ATT_D;
      const int g = lane >> 2, t = lane & 3;
      float acc[3][2][4];
      key_grads<2>((w ? att : w3b) + 16 * (warp & 3), CB_LDX,
                   (w ? dy : q) + hb2, CB_LDX, acc);
      float* dst = dkv + w * CB_S * C;
#pragma unroll
      for (int c3 = 0; c3 < 3; ++c3)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dst[(g + 8 * (e >> 1)) * C + hb2 + 16 * c3 + 8 * j + 2 * t +
                (e & 1)] += acc[c3][j][e];
    }
    cp_async_wait<0>();
    __syncthreads();
    // ---- q ------------------------------------------------------------
    save_rows(op + CB_OP_XN, CB_OPW, x1, CB_LDX, C);
    save_rows(op + CB_OP_DQ, CB_OPW, w1b, CB_LDX, C);
    gemm_pass<192, 3>(w1b, CB_LDX, w1t + CB_CQ * C, C, C, ring,
                      [&](int r, int c, float v0, float v1) {
                        if (valid(r))
                          put(static_cast<bf16*>(a.d_xn) +
                                  (size_t)tok(r) * C + c,
                              v0, v1);
                      });
    __syncthreads();
    QV_STAMP(cross_tail_bwd, 8);
  };
  const int nb = (d.B - unit + units - 1) / units;   // the unit's samples
  if constexpr (PAIR) {
    for (int k = 0; k < nb; ++k) {
      const int bs[2] = {unit + k * units, unit + k * units};
      pass(2 * k + rank, bs, 1);
    }
    __threadfence();
    cluster_sync();     // both CTAs' operand rows and sums are written
    QV_STAMP(cross_tail_bwd, 11);
  } else {
    for (int k0 = 0; k0 < nb; k0 += 2) {
      const int ns = nb - k0 < 2 ? nb - k0 : 2;
      const int bs[2] = {unit + k0 * units, unit + (k0 + 1) * units};
      pass(k0 / 2, bs, ns);
    }
  }
  // the dense layers' weight gradients over every row of the block (the
  // cluster: rank 0 fc2, proj and q, rank 1 the others, half the FLOPs
  // each), each stored once into the slice (the guarded cross q's zero)
  const bool r0 = !PAIR || rank == 0, r1 = !PAIR || rank == 1;
  // (n = 64: an item of three 16-column tiles a warp, every N here a
  // multiple of 48)
  auto wgrad = [&](int ao, int K, int bo, int N, float* w, int ldg,
                   float* bias) {
    wgrad_block<PAIR ? 3 : 1>(
        ops + ao, ops + bo, CB_OPW, PASS_ROWS * (PAIR ? 2 * nb : (nb + 1) / 2),
        K, N, sl(w), ldg, sl(bias), reinterpret_cast<bf16*>(qv_smem),
        CB_BF16);
  };
  auto zero_fill = [&](float* p, int n) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) p[i] = 0.f;
  };
  if (r0) wgrad(CB_OP_HP, HID, CB_OP_DZ, C, gr.fc2_w, C, gr.fc2_b);
  if (r1) {
    wgrad(CB_OP_FIN, C, CB_OP_DH, HID, gr.fc1_w, HID, gr.fc1_b);
    wgrad(CB_OP_G1, HID, CB_OP_DBN2, C, gr.bn2_w, C, gr.bn2_b);
    wgrad(CB_OP_FU, C, CB_OP_DH1, HID, gr.bn1_w, HID, gr.bn1_b);
    for (int i = 0; i < 4; ++i)
      wgrad(CB_OP_NRM + C * i, C, CB_OP_DCC + CB_DC * i, CB_DC,
            gr.comp_w[i], CB_DC, gr.comp_b[i]);
  }
  if (r0) wgrad(CB_OP_ATT, C, CB_OP_DX3, C, gr.cp_w, C, gr.cp_b);
  if constexpr (PAIR) {
    // the pair's sums, in rank order, half the elements each
    const float* c0 = scr + CB_DKV;
    const float* c1 = c0 + CB_DKV + CA_N;
    auto store = [&](float* field, int off, int n) {
      float* dst = sl(field);
      if (dst == nullptr) return;
      for (int i = threadIdx.x + rank * NTHREADS; i < n; i += 2 * NTHREADS)
        dst[i] = c0[off + i] + c1[off + i];
    };
    store(gr.gamma, CA_GAMMA, 1);
    store(gr.fusion, CA_FUSION, 4);
    store(gr.pdn_s, CA_PDN, HID);
    store(gr.pdn_b, CA_PDN + HID, HID);
    store(gr.dw_scale, CA_DWS, HID);
    if (d.dw_bias) store(gr.dw_b, CA_DWB, HID);
    store(gr.dw_w, CA_DWW, 9 * HID);
    store(gr.dwn_s, CA_DWN, HID);
    store(gr.dwn_b, CA_DWN + HID, HID);
    store(gr.norm2_s, CA_NORM2, C);
    store(gr.norm2_b, CA_NORM2 + C, C);
    for (int i = 0; i < 4; ++i) {
      store(gr.norm_s[i], CA_NORM + 2 * C * i, C);
      store(gr.norm_b[i], CA_NORM + 2 * C * i + C, C);
    }
    if (zero_attn) {    // nothing reaches q, the bank or its projections
      if (r0) {
        zero_fill(sl(gr.cq_w), C * C);
        zero_fill(sl(gr.cq_b), C);
      }
      zero_fill(sl(rank ? gr.cv_w : gr.ck_w), C * C);
      zero_fill(sl(rank ? gr.cv_b : gr.ck_b), C);
      zero_fill(sl(rank ? gr.bank_v : gr.bank_k), S * C);
      return;
    }
  }
  if (zero_attn) return;
  if (r0) wgrad(CB_OP_XN, C, CB_OP_DQ, C, gr.cq_w, C, gr.cq_b);
  QV_STAMP(cross_tail_bwd, 9);
  // the bank K/V projections, once a block (a cluster: rank 0 K's, rank 1
  // V's, from the pair's sums in rank order): their weight gradients from
  // the rounded bank rows and the summed cotangents, and the bank rows'
  // gradients through the float32 weights rounded, as the float32 kernel
  float* dk = reinterpret_cast<float*>(q);
  float* dv = dk + CB_S * C;
  if constexpr (PAIR) {
    const float* s0 = scr + rank * CB_S * C;
    const float* s1 = s0 + CB_DKV + CA_N;
    // the pair's sums, and the rounded bank rows (dv's space)
    const float* bank = rank ? a.c.bank_vr : a.c.bank_kr;
    for (int i = threadIdx.x; i < CB_S * C; i += blockDim.x) {
      dk[i] = s0[i] + s1[i];
      dv[i] = i < S * C ? bank[i] : 0.f;
    }
    __syncthreads();
    // the projection's kernel bank^T @ sum and its bias, stored
    const float* br = dv;
    float* gw = sl(rank ? gr.cv_w : gr.ck_w);
    float* gb = sl(rank ? gr.cv_b : gr.ck_b);
    for (int i = threadIdx.x; i < C * C / 4; i += blockDim.x) {
      const int kk = i / (C / 4), j = 4 * (i - kk * (C / 4));
      float4 acc = {0.f, 0.f, 0.f, 0.f};   // columns j..j+3 of row kk
      for (int mm = 0; mm < S; ++mm) {
        const float b = br[mm * C + kk];
        const float4 dd = *reinterpret_cast<const float4*>(dk + mm * C + j);
        acc.x = fmaf(b, dd.x, acc.x);
        acc.y = fmaf(b, dd.y, acc.y);
        acc.z = fmaf(b, dd.z, acc.z);
        acc.w = fmaf(b, dd.w, acc.w);
      }
      float* o = gw + kk * C + j;      // a slice field: 4-byte aligned
      o[0] = acc.x;
      o[1] = acc.y;
      o[2] = acc.z;
      o[3] = acc.w;
    }
    for (int j = threadIdx.x; j < C; j += blockDim.x) {
      float acc = 0.f;
      for (int mm = 0; mm < S; ++mm) acc += dk[mm * C + j];
      gb[j] = acc;
    }
    dense_dgrad<bf16>(dk, C, S, C, rank ? f.cv_w : f.ck_w, C, C, 1, 0,
                      sl(rank ? gr.bank_v : gr.bank_k), C, false);
  } else {
    for (int i = threadIdx.x; i < 2 * CB_S * C; i += blockDim.x)
      dk[i] = dkv[i];
    __syncthreads();
    dense_wgrad(a.c.bank_kr, C, 0, S, C, dk, C, C, 1, sl(gr.ck_w), C,
                sl(gr.ck_b));
    dense_wgrad(a.c.bank_vr, C, 0, S, C, dv, C, C, 1, sl(gr.cv_w), C,
                sl(gr.cv_b));
    dense_dgrad<bf16>(dk, C, S, C, f.ck_w, C, C, 1, 0, sl(gr.bank_k), C,
                      true);
    dense_dgrad<bf16>(dv, C, S, C, f.cv_w, C, C, 1, 0, sl(gr.bank_v), C,
                      true);
  }
  __syncthreads();
  QV_STAMP(cross_tail_bwd, 10);
}

__global__ void __launch_bounds__(NTHREADS, 1)
    cross_tail_bwd_mma_kernel(CrossTailBwdMmaArgs m) {
  cross_tail_bwd_mma<WS>(m);
}

__global__ void __launch_bounds__(NTHREADS, 1)
    cross_tail_bwd_mma64_kernel(CrossTailBwdMmaArgs m) {
  cross_tail_bwd_mma<8>(m);
}

}  // namespace qv

// bf16 at hqavit_c100's widths: `a` as for qv_unit_cross_tail_bwd (its
// scratch cross_tail_bwd_mma_scratch_floats(d) a block), the bf16 weights
// beside it (CrossTailBwdMmaArgs).  ERR_ARGS for any other geometry or
// type (the wrapper checks them first, cross_tail_bwd_mma_error).
extern "C" int qv_unit_cross_tail_bwd_mma(const qv::CrossTailBwdArgs* a,
                                          const void* w, int is_bf16,
                                          void* stream) {
  const qv::Dims& d = a->f.d;
  if (!is_bf16 || d.n != qv::NT || d.side != qv::WS ||
      d.c != qv::CB_C || d.heads != qv::CB_H || d.bank_s > qv::CB_S ||
      d.ccf_hidden != qv::CB_HID || d.bottleneck_hidden != qv::CB_HID ||
      d.d_c != qv::CB_DC || !d.stab_ccf || !d.stab_dw || d.grid > d.B)
    return qv::ERR_ARGS;
  const qv::CrossTailBwdMmaArgs m{*a, static_cast<const qv::bf16*>(w)};
  const int rc = qv_launch(qv::cross_tail_bwd_mma_kernel, m,
                           qv::CB_SMEM_BYTES, stream, d.grid);
  if (rc != 0) return rc;
  return qv_reduce(a->c.gws, a->c.grad, d.grid, a->c.wstride, d.rgrid, stream);
}

// bf16 at hqavit_tiny_in's widths, n = 64 on an 8x8 grid
// (cross_tail_bwd_mma64_kernel): d.grid clusters of two CTAs, one
// gradient slice each in `gws` (which may hold anything: the kernel
// stores every field), a scratch of cross_tail_bwd_mma_scratch_floats(d)
// a cluster.  A cluster launch the card refuses returns its CUDA error.
extern "C" int qv_unit_cross_tail_bwd_mma64(const qv::CrossTailBwdArgs* a,
                                            const void* w, int is_bf16,
                                            void* stream) {
  const qv::Dims& d = a->f.d;
  if (!is_bf16 || d.n != 64 || d.side != 8 ||
      d.c != qv::CB_C || d.heads != qv::CB_H || d.bank_s > qv::CB_S ||
      d.ccf_hidden != qv::CB_HID || d.bottleneck_hidden != qv::CB_HID ||
      d.d_c != qv::CB_DC || !d.stab_ccf || !d.stab_dw || d.grid > d.B)
    return qv::ERR_ARGS;
  const qv::CrossTailBwdMmaArgs m{*a, static_cast<const qv::bf16*>(w)};
  const int rc = qv_launch_cluster(qv::cross_tail_bwd_mma64_kernel, m,
                                   qv::CB64_SMEM_BYTES, stream, d.grid, 2);
  if (rc != 0) return rc;
  return qv_reduce(a->c.gws, a->c.grad, d.grid, a->c.wstride, d.rgrid, stream);
}

extern "C" int qv_unit_cross_tail_bwd_mma_smem(const qv::Dims*) {
  return qv::CB_SMEM_BYTES;
}

extern "C" int qv_unit_cross_tail_bwd_mma_scratch(const qv::Dims* d) {
  return qv::cross_tail_bwd_mma_scratch_floats(*d);
}

extern "C" int qv_unit_cross_tail_bwd_mma64_smem(const qv::Dims*) {
  return qv::CB64_SMEM_BYTES;
}

extern "C" int qv_unit_cross_tail_bwd_mma64_scratch(const qv::Dims* d) {
  return qv::cross_tail_bwd_mma_scratch_floats(*d);
}

// CTAs of cross_tail_bwd_mma64_kernel resident per SM and its two-CTA
// clusters resident at once on the card (0 on the host)
extern "C" int qv_unit_cross_tail_bwd_mma64_occupancy(int* per_sm,
                                                      int* clusters) {
  return qv_cluster_occupancy(qv::cross_tail_bwd_mma64_kernel,
                              qv::CB64_SMEM_BYTES, 2, per_sm, clusters);
}
