// Unit 4 of the fused block, forward (eval and train): cross branch +
// block tail.
//
// Replaces the TPU unit qavit_tpu/kernels/fused_kernels.py
// make_cores.core_cross_tail (fused_cores.py:699 cross_bd, :779 tail_bd),
// run through fused_pallas.py:190-212 fwd_call.
//
// Per sample: cross-attention of the 16 tokens onto the bank (q = Dense
// 192 -> 192 on xn, bank K/V = Dense 192 -> 192 on the 16 slots,
// computed once per block as in the TPU body), proj; then the tail:
// 4 x (LN + compress 192 -> 48), softmax fusion weights, bottleneck
// 192 -> 96 GELU -> 192, residual; norm2, CCF-FFN fc1 192 -> 96, GELU,
// LN, 3x3 depthwise correlation on the 4x4 grid with a zero halo
// (bias before the 0.1 scale), LN, fc2 96 -> 192, x gamma; residual.
// In training: the hash dropout masks and the per-sample drop-path
// factors of both residuals.
//
// Bound on the H100 at B=1024 (bf16): five [B,16,192] inputs read and one
// written, 37.7 MB (~11 us at 3.35 TB/s), against ~8.5 GFLOP (~9 us): the
// bytes bound it.  A 256-thread block holds one sample at a time and
// reads each input once into shared memory (~139 KB, float32, above the
// 48 KB static limit, so the launch opts in to dynamic shared memory) and
// writes only y; no intermediate of the tail touches device memory.  It
// runs on the CUDA cores in float32 and is latency-bound for now.
//
// n = 64 (hqavit_tiny_in, eval): everything but the dwconv works row by
// row, so cross_tail_tiled_kernel runs a sample as two passes over
// 16-token tiles with the per-tile buffers of the n = 16 kernel: the
// first up to the dwconv's input, kept for the whole sample (64 x 96
// floats) beside x + bottleneck (64 x 192, the residual the second pass
// adds to); the second the dwconv over the 8x8 grid (its halo rows come
// from the neighbouring tiles), post-norm, fc2 and the residual.  188 KB
// of shared memory at C=192; the bank rows share the residual's space
// during the per-block prologue.  That is the float32 kernel at n = 64.
//
// bf16 at n = 64, cross_tail_mma_kernel.  Bound on the H100 at B=1024:
// five [1024, 64, 192] bf16 inputs, the output and the float32 weights,
// 152 MB (~45 us at 3.35 TB/s), against 25.1 GFLOP (~25 us): the bytes
// bound it, but the tiled kernel ran 160x the bound on the CUDA cores,
// re-reading its ~737 KB of float32 weights for each 16-row tile.  So
// every dense layer runs on the tensor cores (mma.sync m16n8k16, bf16
// operands, float32 sums) over all 64 rows of a sample, its weight
// streamed once per sample through a three-buffer cp.async ring: cq, cp,
// the four compress layers in one product (each warp's A rows from its
// own branch), bottleneck fc1, fc2, CCF-FFN fc1, fc2; the wrapper packs
// and casts the weights once per call into two bf16 matrices.  One block
// per SM walks the samples with every intermediate as bf16 in shared
// memory (226 KB): the bank's K/V projections once per block; cross
// attention of 16 queries x 2 heads a warp over the S bank keys, scores
// in registers (warp_attention); LayerNorms by eight lanes a row; the
// 3x3 dwconv on the CUDA cores over the sample's whole 8x8 grid, so no
// second pass; the output staged in place of x1 and stored as 16-byte
// copies.  While the dwconv runs, cp.async brings the next sample's five
// inputs.  Every bf16 rounding point of the plain version is kept.  The
// batch-wide NaN guard is kept (q, the projected bank, the attention
// output); the redo runs every sample with a zero cross attention
// output.  Time at B=1024 on an NVIDIA H100 80GB HBM3, 700.00 W:
// PERF.md section 6 row 4 @n64.
#include "mma_ops.cuh"
#include "unit_cross_tail.cuh"

namespace qv {

__host__ __device__ inline int cross_tail_smem_floats(const Dims& d) {
  const int c = d.c, s = d.bank_s;
  const int hid = d.ccf_hidden > d.bottleneck_hidden ? d.ccf_hidden
                                                     : d.bottleneck_hidden;
  return 6 * NT * c          // xn/branch, q/fused, att/x1, cross, fin, y
         + 4 * s * c         // bank rows k, v; projected bank k, v
         + NT * hid          // hidden activations
         + NT * hid          // dwconv output
         + pad4(d.heads * NT * s)
         + 2 * NT;           // LN stats
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS, 1)
    cross_tail_kernel(CrossTailArgs a) {
  QV_SMEM_DECL
  __shared__ int bad;
  const Dims& d = a.d;
  const int c = d.c, S = d.bank_s;
  const int hmax = d.ccf_hidden > d.bottleneck_hidden ? d.ccf_hidden
                                                      : d.bottleneck_hidden;
  float* A = qv_smem;          // xn, then each branch's LN
  float* Q = A + NT * c;       // cross q, then the fused concat
  float* R = Q + NT * c;       // attention output, then x + bottleneck
  float* X = R + NT * c;       // cross branch output
  float* Y = X + NT * c;       // bottleneck output, then norm2
  float* Z = Y + NT * c;       // fc2 output, then the block output
  float* bk = Z + NT * c;
  float* bv = bk + S * c;
  float* kb = bv + S * c;
  float* vb = kb + S * c;
  float* H1 = vb + S * c;
  float* H2 = H1 + NT * hmax;
  float* sc = H2 + NT * hmax;
  float* stats = sc + pad4(d.heads * NT * S);
  const CrossTailBufs s{A,  Q,  kb, vb, R,  X,  sc, sc, A,  Q,  Q,  H1, H1,
                        Y,  R,  Y,  H1, H1, H1, H2, H2, H2, Z,  Z,  stats};

  if (threadIdx.x == 0) bad = 0;
  load_rounded<T>(bk, a.bank_k, S * c);
  load_rounded<T>(bv, a.bank_v, S * c);
  __syncthreads();
  cross_tail_prologue<T>(a, bk, bv, s);
  auto sample = [&](int b, bool zero_attn) {
    cross_tail_body<T>(a, b, zero_attn, s, &bad);
    store_tile<T>(static_cast<T*>(a.y) + (size_t)b * NT * c, Z, NT * c);
    __syncthreads();
  };
  for (int b = blockIdx.x; b < d.B; b += gridDim.x) sample(b, false);
  if (d.guard)
    finish_guard(a.ws, bad, [&] {
      for (int b = 0; b < d.B; ++b) sample(b, true);
    });
}

__host__ __device__ inline int cross_tail_tiled_smem_floats(const Dims& d) {
  const int c = d.c, s = d.bank_s;
  const int hmax = d.ccf_hidden > d.bottleneck_hidden ? d.ccf_hidden
                                                      : d.bottleneck_hidden;
  const int x1 = d.n * c > 2 * s * c ? d.n * c : 2 * s * c;
  return 6 * NT * c          // xn/branch, q/fused, att, cross, fin, y
         + 2 * s * c         // projected bank k, v
         + 2 * NT * hmax     // bottleneck hidden; dwconv output
         + pad4(d.heads * NT * s)
         + 2 * NT            // LN stats
         + x1                // x + bottleneck, all rows; bank rows k, v
         + d.n * d.ccf_hidden;  // the dwconv's input, all rows
}

// Eval only, n a multiple of NT; one block per sample.
template <typename T>
__global__ void __launch_bounds__(NTHREADS, 1)
    cross_tail_tiled_kernel(CrossTailArgs a) {
  QV_SMEM_DECL
  __shared__ int bad;
  const Dims& d = a.d;
  const int c = d.c, S = d.bank_s, n = d.n, hc = d.ccf_hidden;
  const int hmax = d.ccf_hidden > d.bottleneck_hidden ? d.ccf_hidden
                                                      : d.bottleneck_hidden;
  float* A = qv_smem;          // xn, then each branch's LN
  float* Q = A + NT * c;       // cross q, then the fused concat
  float* R = Q + NT * c;       // attention output
  float* X = R + NT * c;       // cross branch output
  float* Y = X + NT * c;       // bottleneck output, then norm2
  float* Z = Y + NT * c;       // fc2 output, then the block output
  float* kb = Z + NT * c;
  float* vb = kb + S * c;
  float* H1 = vb + S * c;      // bottleneck hidden
  float* H2 = H1 + NT * hmax;  // dwconv output
  float* sc = H2 + NT * hmax;
  float* stats = sc + pad4(d.heads * NT * S);
  float* X1 = stats + 2 * NT;  // [n, c] x + bottleneck
  float* HD = X1 + (n * c > 2 * S * c ? n * c : 2 * S * c);  // [n, hc]

  if (threadIdx.x == 0) bad = 0;
  load_rounded<T>(X1, a.bank_k, S * c);
  load_rounded<T>(X1 + S * c, a.bank_v, S * c);
  __syncthreads();
  {
    CrossTailBufs p{};
    p.kb = kb;
    p.vb = vb;
    cross_tail_prologue<T>(a, X1, X1 + S * c, p);
  }
  // the buffers of rows [t0, t0 + NT)
  auto tile = [&](int t0) {
    return CrossTailBufs{A,  Q,  kb, vb, R,  X,  sc, sc, A,
                         Q,  Q,  H1, H1, Y,  X1 + t0 * c, Y,
                         HD + t0 * hc, HD + t0 * hc, HD + t0 * hc,
                         H2, H2, H2, Z,  Z,  stats};
  };
  auto sample = [&](int b, bool zero_attn) {
    for (int t0 = 0; t0 < n; t0 += NT)   // the dwconv's input lands in HD
      cross_tail_front<T>(a, b, t0, zero_attn, tile(t0), &bad);
    for (int t0 = 0; t0 < n; t0 += NT) {
      const CrossTailBufs s = tile(t0);
      ccf_dwconv<T>(a, HD, t0, s);
      cross_tail_back<T>(a, b, t0, s);
      store_tile<T>(static_cast<T*>(a.y) + ((size_t)b * n + t0) * c, Z,
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

struct CrossTailMmaArgs {
  CrossTailArgs f;        // the unit's arguments (its dense kernels unread)
  // the dense kernels rounded to bf16, side by side: [C, CT_W1] holds cq,
  // ck, cv, cp, compress_0..3, bottleneck fc1, CCF-FFN fc1 (C input rows
  // each); [CT_HID, CT_W2] bottleneck fc2, CCF-FFN fc2
  const bf16* w1;
  const bf16* w2;
};

// the geometry cross_tail_mma_kernel is written for
// (fused_kernels.cross_tail_mma_error)
constexpr int CT_N = 64, CT_C = 192, CT_H = 4, CT_SIDE = 8;
constexpr int CT_S = 16;                // bank rows, at most
constexpr int CT_HID = 96;              // bottleneck and CCF-FFN hidden
constexpr int CT_DC = 48;               // compressed width of a branch
static_assert(CT_C / CT_H == ATT_D, "warp_attention's head width");
static_assert(4 * CT_DC == CT_C, "the four compressed branches fill C");
// column offsets in w1 and w2
constexpr int CT_CQ = 0, CT_CK = CT_C, CT_CP = 3 * CT_C, CT_COMP = 4 * CT_C;
constexpr int CT_BN1 = CT_COMP + 4 * CT_DC, CT_FC1 = CT_BN1 + CT_HID;
constexpr int CT_W1 = CT_FC1 + CT_HID;
constexpr int CT_BN2 = 0, CT_FC2 = CT_C, CT_W2 = 2 * CT_C;
// leading dims: 8 bf16 past the width (ldmatrix rows in distinct banks)
constexpr int CT_LDX = CT_C + 8, CT_LDH = CT_HID + 8, CT_LDKV = 2 * CT_C + 8;
// shared memory, in bf16 elements
constexpr int CT_ROWS = CT_N * CT_LDX;          // one [64, C] buffer
constexpr int CT_STAGES = 3;                    // ring buffers
constexpr int CT_SMEM_BYTES =
    2 * (2 * CT_S * CT_LDX      // projected bank k, v
         + 6 * CT_ROWS          // xn / att / fused; x / x1; 4 branch rows
         + 2 * CT_N * CT_LDH    // hidden rows, dwconv output
         + CT_STAGES * RING_KS * CT_LDX);  // weight slices
static_assert(2 * RING_KS * CT_LDKV <= 2 * CT_ROWS, "the bank's kv ring");

// One block per SM walks the samples; every product runs over all 64 rows
// of a sample (four m16 tiles) with its weight streamed once through the
// cp.async ring.  The buffers of one sample:
//   xa   xn; then the cross attention rows; then the weighted concat
//   x1   x; then x1 = x + bottleneck; then the block output
//   br   the branch outputs swa, msda, cga, cross, each normed in place
//        for its compress; br[3] then norm2(x1); then the next sample's x
//        (x1 and br[3] swap roles at the end of a sample)
//   h    bottleneck hidden; then CCF-FFN hidden, normed in place
//   h2   the dwconv's output, normed in place
// While the dwconv runs, cp.async brings the next sample's five inputs.
__global__ void __launch_bounds__(NTHREADS, 1)
    cross_tail_mma_kernel(CrossTailMmaArgs m) {
  QV_SMEM_DECL
  __shared__ int bad;
  const CrossTailArgs& a = m.f;
  const Dims& d = a.d;
  const int S = d.bank_s, C = CT_C;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  bf16* kb = reinterpret_cast<bf16*>(qv_smem);
  bf16* vb = kb + CT_S * CT_LDX;
  bf16* xa = vb + CT_S * CT_LDX;
  bf16* x1 = xa + CT_ROWS;
  bf16* br[4] = {x1 + CT_ROWS, x1 + 2 * CT_ROWS, x1 + 3 * CT_ROWS,
                 x1 + 4 * CT_ROWS};
  bf16* h = x1 + 5 * CT_ROWS;
  bf16* h2 = h + CT_N * CT_LDH;
  bf16* ring = h2 + CT_N * CT_LDH;

  if (threadIdx.x == 0) bad = 0;
  // per block: the cross branch's bank K/V projections.  The bank rows
  // rounded (k rows 0-15, v rows 16-31 of xa, rows past S zero), then
  // [k; v] @ [ck | cv]: warps 0-3 the k columns, 4-7 the v columns, the
  // weight streamed through br[0..1]
  for (int i = threadIdx.x; i < 2 * CT_S * C; i += blockDim.x) {
    const int r = i / C, c = i - r * C, rr = r % CT_S;
    const float* src = r < CT_S ? a.bank_k : a.bank_v;
    xa[r * CT_LDX + c] = from_f<bf16>(rr < S ? rnd<bf16>(src[rr * C + c])
                                             : 0.f);
  }
  __syncthreads();
  {
    const int kv = warp >> 2;
    float acc[1][6][4];
    ring_gemm<1, 6>(xa + kv * CT_S * CT_LDX, CT_LDX, m.w1 + CT_CK, CT_W1,
                    2 * C, C, br[0], CT_LDKV, 48 * warp, acc);
    const float* bias = kv ? a.cv_b : a.ck_b;
    bf16* dst = kv ? vb : kb;
    bool nan_seen = false;
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      const int col = 48 * (warp & 3) + 8 * j + 2 * t;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = g + 8 * hf;
        float v0 = 0.f, v1 = 0.f;
        if (r < S) {
          v0 = dense_out(acc[0][j][2 * hf], bias[col]);
          v1 = dense_out(acc[0][j][2 * hf + 1], bias[col + 1]);
          nan_seen = nan_seen || isnan(v0) || isnan(v1);
        }
        store_bf16x2(dst + r * CT_LDX + col, pack_bf16x2(v0, v1));
      }
    }
    if (d.guard && nan_seen) bad = 1;
  }
  float fw[4];
  fusion_weights(a.fusion, fw);

  // the five inputs of sample b: xn, x (into xbuf), swa, msda, cga
  auto stage = [&](int b, bf16* xbuf) {
    const size_t off = (size_t)b * CT_N * C;
    auto rows = [&](bf16* dst, const void* src) {
      for (int i = threadIdx.x; i < CT_N * (C / 8); i += blockDim.x) {
        const int r = i / (C / 8), c = (i - r * (C / 8)) * 8;
        cp_async_16(dst + r * CT_LDX + c,
                    static_cast<const bf16*>(src) + off + r * C + c);
      }
    };
    rows(xa, a.xn);
    rows(xbuf, a.x);
    rows(br[0], a.swa);
    rows(br[1], a.msda);
    rows(br[2], a.cga);
    cp_async_commit();
  };
  // the warp's rows (16 mt..) and columns (qcol..) in the products of
  // 192 columns; of 96 columns, 48 from hcol
  const int mt = warp >> 1, half = warp & 1;
  const int qcol = half * (C / 2), hcol = half * (CT_HID / 2);

  // sample b; `next` (if >= 0) is staged during the dwconv
  auto sample = [&](int b, int next, bool zero_attn) {
    cp_async_wait<0>();
    __syncthreads();
    // ---- cross branch ------------------------------------------------
    unsigned qa[2][3][4];
    {
      float acc[1][12][4];
      ring_gemm<1, 12, CT_STAGES>(xa + mt * 16 * CT_LDX, CT_LDX,
                                  m.w1 + CT_CQ, CT_W1, C, C, ring, CT_LDX,
                                  qcol, acc);
      if (q_fragments(acc, a.cq_b, qcol, qa) && d.guard && !zero_attn)
        bad = 1;
    }
    {  // xn is read: the attention rows of heads 2 half, 2 half + 1 go
       // to xa, over the S projected bank keys (past S: -inf)
      const bf16* const kt[1] = {kb};
      const bf16* const vt[1] = {vb};
      bf16* out = xa + mt * 16 * CT_LDX;
      bool nan_seen = false;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int hc = (2 * half + hh) * ATT_D;
        if (zero_attn) {
          for (int e = lane; e < 16 * ATT_D / 2; e += 32) {
            const int r = e / (ATT_D / 2), c = 2 * (e - r * (ATT_D / 2));
            store_bf16x2(out + r * CT_LDX + hc + c, pack_bf16x2(0.f, 0.f));
          }
        } else {
          nan_seen |= warp_attention<1>(qa[hh], kt, vt, CT_LDX, hc, S, out,
                                        CT_LDX);
        }
      }
      if (d.guard && nan_seen) bad = 1;
    }
    __syncthreads();
    {  // the cross branch output: att @ W_cp + b -> br[3]
      float acc[1][12][4];
      ring_gemm<1, 12, CT_STAGES>(xa + mt * 16 * CT_LDX, CT_LDX,
                                  m.w1 + CT_CP, CT_W1, C, C, ring, CT_LDX,
                                  qcol, acc);
#pragma unroll
      for (int j = 0; j < 12; ++j) {
        const int col = qcol + 8 * j + 2 * t;
        const float b0 = a.cp_b[col], b1 = a.cp_b[col + 1];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          store_bf16x2(br[3] + (mt * 16 + g + 8 * hf) * CT_LDX + col,
                       pack_bf16x2(dense_out(acc[0][j][2 * hf], b0),
                                   dense_out(acc[0][j][2 * hf + 1], b1)));
      }
    }
    __syncthreads();
    // ---- tail: per-branch LN + compress, softmax-weighted concat -------
#pragma unroll
    for (int i = 0; i < 4; ++i)
      ln_rows<CT_N, CT_C>(br[i], br[i], CT_LDX, a.norm_s[i], a.norm_b[i]);
    __syncthreads();
    {  // warp (i, rh): branch i = warp / 2, rows 32 rh.., its 48 columns
       // of the concat; the fused rows go to xa
      const int i = warp >> 1, rh = warp & 1;
      float acc[2][6][4];
      ring_gemm<2, 6, CT_STAGES>(br[i] + rh * 32 * CT_LDX, CT_LDX,
                                 m.w1 + CT_COMP, CT_W1, C, C, ring, CT_LDX,
                                 CT_DC * i, acc);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < 6; ++j) {
          const int cc = 8 * j + 2 * t;
          const float b0 = a.comp_b[i][cc], b1 = a.comp_b[i][cc + 1];
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
            store_bf16x2(
                xa + (rh * 32 + mi * 16 + g + 8 * hf) * CT_LDX + CT_DC * i +
                    cc,
                pack_bf16x2(rnd<bf16>(dense_out(acc[mi][j][2 * hf], b0) *
                                      fw[i]),
                            rnd<bf16>(dense_out(acc[mi][j][2 * hf + 1], b1) *
                                      fw[i])));
        }
    }
    __syncthreads();
    // ---- bottleneck MLP and the first residual ------------------------
    {  // h = rnd(gelu(fused @ W_bn1 + b))
      float acc[1][6][4];
      ring_gemm<1, 6, CT_STAGES>(xa + mt * 16 * CT_LDX, CT_LDX,
                                 m.w1 + CT_BN1, CT_W1, CT_HID, C, ring,
                                 CT_LDX, hcol, acc);
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        const int col = hcol + 8 * j + 2 * t;
        const float b0 = a.bn1_b[col], b1 = a.bn1_b[col + 1];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          store_bf16x2(
              h + (mt * 16 + g + 8 * hf) * CT_LDH + col,
              pack_bf16x2(gelu_f(dense_out(acc[0][j][2 * hf], b0)),
                          gelu_f(dense_out(acc[0][j][2 * hf + 1], b1))));
      }
    }
    __syncthreads();
    {  // x1 = rnd(x + (h @ W_bn2 + b)), in place
      float acc[1][12][4];
      ring_gemm<1, 12, CT_STAGES>(h + mt * 16 * CT_LDH, CT_LDH,
                                  m.w2 + CT_BN2, CT_W2, C, CT_HID, ring,
                                  CT_LDX, qcol, acc);
#pragma unroll
      for (int j = 0; j < 12; ++j) {
        const int col = qcol + 8 * j + 2 * t;
        const float b0 = a.bn2_b[col], b1 = a.bn2_b[col + 1];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          bf16* p = x1 + (mt * 16 + g + 8 * hf) * CT_LDX + col;
          store_bf16x2(p, pack_bf16x2(
                              to_f<bf16>(p[0]) +
                                  dense_out(acc[0][j][2 * hf], b0),
                              to_f<bf16>(p[1]) +
                                  dense_out(acc[0][j][2 * hf + 1], b1)));
        }
      }
    }
    __syncthreads();
    // ---- CCF-FFN ---------------------------------------------------------
    ln_rows<CT_N, CT_C>(x1, br[3], CT_LDX, a.norm2_s, a.norm2_b);
    __syncthreads();
    {  // h = rnd(gelu(norm2(x1) @ W_fc1 + b))
      float acc[1][6][4];
      ring_gemm<1, 6, CT_STAGES>(br[3] + mt * 16 * CT_LDX, CT_LDX,
                                 m.w1 + CT_FC1, CT_W1, CT_HID, C, ring,
                                 CT_LDX, hcol, acc);
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        const int col = hcol + 8 * j + 2 * t;
        const float b0 = a.fc1_b[col], b1 = a.fc1_b[col + 1];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          store_bf16x2(
              h + (mt * 16 + g + 8 * hf) * CT_LDH + col,
              pack_bf16x2(gelu_f(dense_out(acc[0][j][2 * hf], b0)),
                          gelu_f(dense_out(acc[0][j][2 * hf + 1], b1))));
      }
    }
    __syncthreads();
    // xa and br are read: bring the next sample's inputs, x into br[3]
    if (next >= 0) stage(next, br[3]);
    ln_rows<CT_N, CT_HID>(h, h, CT_LDH, a.dwn_s, a.dwn_b);
    __syncthreads();
    // the 3x3 depthwise correlation on the 8x8 grid (zero halo, bias
    // before the scale), as ccf_dwconv: a thread walks down one column
    // of the grid in one channel, its 3x3 window of inputs in registers
    for (int u = threadIdx.x; u < CT_SIDE * CT_HID; u += blockDim.x) {
      const int gj = u / CT_HID, ch = u - gj * CT_HID;
      float k[9];
#pragma unroll
      for (int i = 0; i < 9; ++i) k[i] = a.dw_w[ch * 9 + i];
      const float bias = d.dw_bias ? rnd<bf16>(a.dw_b[ch]) : 0.f;
      const float scale = rnd<bf16>(a.dw_scale[ch]);
      auto in = [&](int si, int sj) {
        return si >= 0 && si < CT_SIDE && sj >= 0 && sj < CT_SIDE
                   ? to_f<bf16>(h[(si * CT_SIDE + sj) * CT_LDH + ch])
                   : 0.f;
      };
      float win[3][3];
#pragma unroll
      for (int kj = 0; kj < 3; ++kj) {
        win[0][kj] = 0.f;
        win[1][kj] = in(0, gj + kj - 1);
      }
#pragma unroll
      for (int gi = 0; gi < CT_SIDE; ++gi) {
#pragma unroll
        for (int kj = 0; kj < 3; ++kj) win[2][kj] = in(gi + 1, gj + kj - 1);
        float acc = 0.f;
#pragma unroll
        for (int ki = 0; ki < 3; ++ki)
#pragma unroll
          for (int kj = 0; kj < 3; ++kj)
            acc = fmaf(win[ki][kj], k[ki * 3 + kj], acc);
        float yv = rnd<bf16>(acc);
        if (d.dw_bias) yv = rnd<bf16>(yv + bias);
        yv = rnd<bf16>(yv * scale);
        h2[(gi * CT_SIDE + gj) * CT_LDH + ch] = from_f<bf16>(yv);
#pragma unroll
        for (int kj = 0; kj < 3; ++kj) {
          win[0][kj] = win[1][kj];
          win[1][kj] = win[2][kj];
        }
      }
    }
    __syncthreads();
    ln_rows<CT_N, CT_HID>(h2, h2, CT_LDH, a.pdn_s, a.pdn_b);
    __syncthreads();
    {  // y = x1 + rnd((h2 @ W_fc2 + b) * gamma), summed in float32 and
       // rounded once, in place of x1
      float acc[1][12][4];
      ring_gemm<1, 12, CT_STAGES>(h2 + mt * 16 * CT_LDH, CT_LDH,
                                  m.w2 + CT_FC2, CT_W2, C, CT_HID, ring,
                                  CT_LDX, qcol, acc);
      const float gamma = a.gamma[0];
#pragma unroll
      for (int j = 0; j < 12; ++j) {
        const int col = qcol + 8 * j + 2 * t;
        const float b0 = a.fc2_b[col], b1 = a.fc2_b[col + 1];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          bf16* p = x1 + (mt * 16 + g + 8 * hf) * CT_LDX + col;
          store_bf16x2(
              p, pack_bf16x2(
                     to_f<bf16>(p[0]) +
                         rnd<bf16>(dense_out(acc[0][j][2 * hf], b0) * gamma),
                     to_f<bf16>(p[1]) +
                         rnd<bf16>(dense_out(acc[0][j][2 * hf + 1], b1) *
                                   gamma)));
        }
      }
    }
    __syncthreads();
    {  // the block output, 16 bytes a copy
      bf16* y = static_cast<bf16*>(a.y) + (size_t)b * CT_N * C;
      for (int i = threadIdx.x; i < CT_N * (C / 8); i += blockDim.x) {
        const int r = i / (C / 8), c = (i - r * (C / 8)) * 8;
        *reinterpret_cast<uint4*>(y + r * C + c) =
            *reinterpret_cast<const uint4*>(x1 + r * CT_LDX + c);
      }
    }
    bf16* tmp = x1;        // the next sample's x is in br[3]
    x1 = br[3];
    br[3] = tmp;
  };
  if (blockIdx.x < d.B) stage(blockIdx.x, x1);
  for (int b = blockIdx.x; b < d.B; b += gridDim.x)
    sample(b, b + (int)gridDim.x < d.B ? b + (int)gridDim.x : -1, false);
  if (d.guard)
    finish_guard(a.ws, bad, [&] {
      // the redo: every sample with a zero cross attention output
      __syncthreads();
      stage(0, x1);
      for (int b = 0; b < d.B; ++b) sample(b, b + 1 < d.B ? b + 1 : -1, true);
    });
}

}  // namespace qv

extern "C" int qv_unit_cross_tail_smem(const qv::Dims* d);

extern "C" int qv_unit_cross_tail(const qv::CrossTailArgs* a, int is_bf16,
                                  void* stream) {
  const size_t smem = qv_unit_cross_tail_smem(&a->d);
  if (a->d.n != qv::NT) {  // eval only; bf16 is qv_unit_cross_tail_mma's
    if (a->d.train || is_bf16) return qv::ERR_ARGS;
    return qv_launch(qv::cross_tail_tiled_kernel<float>, *a, smem, stream,
                     a->d.grid);
  }
  return is_bf16 ? qv_launch(qv::cross_tail_kernel<qv::bf16>, *a, smem, stream,
                             a->d.grid)
                 : qv_launch(qv::cross_tail_kernel<float>, *a, smem, stream,
                             a->d.grid);
}

extern "C" int qv_unit_cross_tail_smem(const qv::Dims* d) {
  return (d->n == qv::NT ? qv::cross_tail_smem_floats(*d)
                         : qv::cross_tail_tiled_smem_floats(*d)) *
         (int)sizeof(float);
}

// The n = 64 bf16 eval kernel: `a` as for qv_unit_cross_tail, the dense
// kernels rounded to bf16 and packed beside it (CrossTailMmaArgs).
// ERR_ARGS for any other geometry or type (the wrapper checks them
// first, cross_tail_mma_error).
extern "C" int qv_unit_cross_tail_mma(const qv::CrossTailArgs* a,
                                      const void* w1, const void* w2,
                                      int is_bf16, void* stream) {
  const qv::Dims& d = a->d;
  if (!is_bf16 || d.train || d.n != qv::CT_N || d.side != qv::CT_SIDE ||
      d.c != qv::CT_C || d.heads != qv::CT_H || d.bank_s > qv::CT_S ||
      d.ccf_hidden != qv::CT_HID || d.bottleneck_hidden != qv::CT_HID ||
      d.d_c != qv::CT_DC || !d.stab_ccf || !d.stab_dw || d.grid > d.B)
    return qv::ERR_ARGS;
  const qv::CrossTailMmaArgs m{*a, static_cast<const qv::bf16*>(w1),
                               static_cast<const qv::bf16*>(w2)};
  return qv_launch(qv::cross_tail_mma_kernel, m, qv::CT_SMEM_BYTES, stream,
                   d.grid);
}

extern "C" int qv_unit_cross_tail_mma_smem(const qv::Dims*) {
  return qv::CT_SMEM_BYTES;
}

// sizeof of each argument struct, for the loader's layout check (one
// definition for the whole library)
extern "C" int qv_struct_size(int which) {
  switch (which) {
    case 0: return (int)sizeof(qv::Dims);
    case 1: return (int)sizeof(qv::SwaArgs);
    case 2: return (int)sizeof(qv::MsdaArgs);
    case 3: return (int)sizeof(qv::CgaArgs);
    case 4: return (int)sizeof(qv::CrossTailArgs);
    case 5: return (int)sizeof(qv::SwaBwdArgs);
    case 6: return (int)sizeof(qv::MsdaBwdArgs);
    case 7: return (int)sizeof(qv::CgaBwdArgs);
    case 8: return (int)sizeof(qv::CrossTailBwdArgs);
  }
  return -1;
}
