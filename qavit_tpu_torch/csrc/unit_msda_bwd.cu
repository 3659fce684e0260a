// Unit 2 of the fused block, backward: the VJP of the MSDA branch.
//
// Replaces the TPU kernel qavit_tpu/kernels/fused_pallas.py:244 bwd_call
// (pallas_call at :245, bwd_kernel :219-242) for the core `msda`
// (fused_kernels.py:82); PERF.md section 6 row 6.
//
// Per sample: recompute the branch (masks and NaN-guard flag replayed),
// then differentiate proj, attention, the Linformer mix of the pooled
// rows, the kv and q projections (the two column blocks of the one qkv
// kernel) and the constant pooling matrix back to d(xn), written per
// sample in the working type.  Weight and bank gradients go to this
// block's float32 slice; the reduction pass sums the slices in block
// order.
//
// Bound on the H100 at B=1024 (bf16), as chip_smoke.unit_bwd_work counts
// it: 20.1 MB moved (~6 us at 3.35 TB/s) against 14.4 GFLOP (~14.5 us at
// 989 TFLOP/s): the operations bound it.
//
// float32, msda_bwd_kernel: the first design, on the CUDA cores (TF32
// keeps too few digits for the 1e-4 gradient tolerance).  One 256-thread
// block per SM walks the samples with ~221 KB of float32 shared memory;
// per sample it recomputes through msda_body (unit_msda.cuh, the
// forward's code), and each dense_wgrad reads and writes the block's
// gradient slice through L2.  Latency-bound.
//
// bf16 at hqavit_c100's widths, msda_bwd_mma_kernel: every product on the
// tensor cores (mma.sync m16n8k16, bf16 operands, float32 sums) over a
// pass of two samples (32 rows), every activation and cotangent as bf16
// in shared memory (219 KB), the pieces in mma_ops.cuh.  Per pass: the
// pooling as sel_t's sums (token_mix's order), kv and q through the
// weight ring, kc | vc = rnd(E^T @ k | v) per sample, the attention of
// 16 queries x one head a warp with the dropout replayed
// (warp_attention_train); then proj's weight gradient and d(att) = dO @
// W_p^T; warp_attention_bwd (dq, dS, P) and each warp's own d(kc), d(vc)
// = dS^T q, P^T dO; the bank keys' gradients summed over the pass's two
// samples; the Linformer backward (d(E) = k @ d(kc)^T, d(k) = E @
// d(kc)); the qkv weight gradients; d(pooled) = d(kv) @ W_kv^T and d(xn)
// = dq @ W_q^T + sel_t d(pooled), stored once.  The dgrads read
// transposed bf16 weights, which the wrapper makes once per call beside
// the forward's.  The dense weight gradients in^T @ dy are not summed
// per pass: each pass saves its operand rows (bf16) to a per-block
// scratch, and at the end the block forms each gradient over all its
// rows (wgrad_block) and stores it once into its slice.  Summed into the
// slice per pass instead, the slices (132 x 0.62 MB, more than L2 holds)
// were read and written through HBM four times a launch, half the
// kernel's time (1.06 ms a launch, against 0.51 ms with the saved rows).
// Time: PERF.md section 6 row 6.
//
// bf16 at hqavit_tiny_in's widths, n = 64 with 40 pooled rows,
// msda_bwd_mma64_kernel (below): a pass a sample.  Bound at B=128 on the
// H100: 10.7 MB against 7.2 GFLOP (~7.3 us): the operations bound it.
// Time: PERF.md section 6 row 6 @n64.
#include "mma_ops.cuh"
#include "unit_msda.cuh"

namespace qv {

__host__ __device__ inline int msda_bwd_smem_floats(const Dims& d) {
  const int c = d.c, lk = d.lin_k, lkr = lk > NT ? lk : NT;
  const int kvn = pad4(d.heads * NT * (lk + d.bank_s));
  return NT * c             // xs
         + NT * c           // pooled, then d(pooled)
         + NT * 2 * c       // kv, then d(kv)
         + 2 * lk * c       // kc, vc
         + NT * c           // q, then d(q)
         + NT * c           // att
         + NT * c           // d(att), then d(xn)
         + 2 * lkr * c      // d(kc) (out during the recompute), d(vc) (d(out))
         + 3 * kvn;         // P, PV probabilities, d(scores)
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS, 1) msda_bwd_kernel(MsdaBwdArgs a) {
  QV_SMEM_DECL
  __shared__ int bad;
  const MsdaArgs& f = a.f;
  const Dims& d = f.d;
  const int c = d.c, lk = d.lin_k, S = d.bank_s, h = d.heads;
  const int keep = d.msda_keep, lkr = lk > NT ? lk : NT;
  const int kvn = pad4(h * NT * (lk + S));
  float* xs = qv_smem;
  float* pooled = xs + NT * c;
  float* kv = pooled + NT * c;
  float* kc = kv + NT * 2 * c;
  float* vc = kc + lk * c;
  float* q = vc + lk * c;
  float* att = q + NT * c;
  float* dA = att + NT * c;
  float* dkc = dA + NT * c;
  float* dvc = dkc + lkr * c;
  float* sc = dvc + lkr * c;
  float* pr = sc + kvn;
  float* dp = pr + kvn;
  const MsdaBufs s{xs, pooled, kv, kc, vc, a.c.bank_kr, a.c.bank_vr, q, att,
                   dkc, sc, pr};
  const MsdaGrads& g = a.g;
  const bool zero_attn = d.guard && a.c.flag[1] != 0;
  float* gqkv_w = slice(g.qkv_w, a.c);
  float* gqkv_b = slice(g.qkv_b, a.c);

  for (int b = blockIdx.x; b < d.B; b += gridDim.x) {
    const size_t off = (size_t)b * NT * c;
    msda_body<T>(f, b, zero_attn, s, &bad);
    // proj dropout and proj (d(out) in dvc)
    load_tile<T>(dvc, static_cast<const T*>(a.d_out) + off, NT * c);
    __syncthreads();
    drop_rows(d, MSDA_PROJ, (unsigned)(b * NT * c), dvc, NT * c);
    __syncthreads();
    dense_wgrad(att, c, 0, NT, c, dvc, c, c, 1, slice(g.proj_w, a.c), c,
                slice(g.proj_b, a.c));
    dense_dgrad<T>(dvc, c, NT, c, f.proj_w, c, c, 1, 0, dA, c, false);
    __syncthreads();
    // a guarded branch passes zero gradient through its attention, so
    // nothing before it gets any
    if (zero_attn) {
      fill(dA, NT * c, 0.f);
      __syncthreads();
    } else {
      // attention; d(q) over q
      attention_bwd<T>(q, c, NT, h, c / h, kc, vc, c, lk, s.bk, s.bv, c, S, h,
                       dA, c, sc, pr, dp, attn_drop(d, MSDA_ATTN),
                       (unsigned)b * h * NT * (lk + S), q, c, dkc, dvc, c,
                       slice(g.bank_k, a.c), slice(g.bank_v, a.c), c);
      // Linformer over the pooled rows: d(E[:keep]), then d(k), d(v) over kv
      token_mix_bwd<T>(f.e_k, lk, keep, kv, 2 * c, dkc, c, c, kv, 2 * c,
                       false, slice(g.e_k, a.c));
      token_mix_bwd<T>(f.e_v, lk, keep, kv + c, 2 * c, dvc, c, c, kv + c,
                       2 * c, false, slice(g.e_v, a.c));
      // the kv and q column blocks of the qkv kernel
      dense_wgrad(pooled, c, 0, keep, c, kv, 2 * c, 2 * c, 1, gqkv_w + c,
                  3 * c, gqkv_b + c);
      dense_wgrad(xs, c, 0, NT, c, q, c, c, 1, gqkv_w, 3 * c, gqkv_b);
      __syncthreads();
      dense_dgrad<T>(kv, 2 * c, keep, 2 * c, f.qkv_w + c, 3 * c, c, 1, 0,
                     pooled, c, false);
      dense_dgrad<T>(q, c, NT, c, f.qkv_w, 3 * c, c, 1, 0, dA, c, false);
      __syncthreads();
      // the pooling matrix
      token_mix_bwd<T>(f.sel_t, keep, NT, nullptr, 0, pooled, c, c, dA, c,
                       true, nullptr);
    }
    store_tile<T>(static_cast<T*>(a.d_xn) + off, dA, NT * c);
    __syncthreads();
  }
}

}  // namespace qv

extern "C" int qv_unit_msda_bwd(const qv::MsdaBwdArgs* a, int is_bf16,
                                void* stream) {
  const qv::Dims& d = a->f.d;
  const size_t smem = qv::msda_bwd_smem_floats(d) * sizeof(float);
  const int rc =
      is_bf16 ? qv_launch(qv::msda_bwd_kernel<qv::bf16>, *a, smem, stream,
                          d.grid)
              : qv_launch(qv::msda_bwd_kernel<float>, *a, smem, stream, d.grid);
  if (rc != 0) return rc;
  return qv_reduce(a->c.gws, a->c.grad, d.grid, a->c.wstride, d.rgrid, stream);
}

extern "C" int qv_unit_msda_bwd_smem(const qv::Dims* d) {
  return qv::msda_bwd_smem_floats(*d) * (int)sizeof(float);
}

// --- bf16 at hqavit_c100's widths: the tensor-core kernel --------------------

namespace qv {

struct MsdaBwdMmaArgs {
  MsdaBwdArgs a;          // the float32 kernel's arguments
  // bf16 [C, 3C] qkv | [C, C] proj | [3C, C] qkv^T | [C, C] proj^T
  const bf16* w;
};

// the geometry msda_bwd_mma_kernel is written for
// (fused_kernels.msda_bwd_mma_error)
constexpr int MB_C = 192, MB_H = 4, MB_LK = 32, MB_S = 16, MB_KEEP = 16;
static_assert(MB_C / MB_H == ATT_D, "warp_attention's head width");
constexpr int MB_QKV = 0, MB_PROJ = 3 * MB_C * MB_C;
constexpr int MB_QKVT = 4 * MB_C * MB_C, MB_PROJT = 7 * MB_C * MB_C;
// leading dims: 8 bf16 past the width (ldmatrix rows in distinct banks)
constexpr int MB_LDX = MB_C + 8, MB_LDKV = 2 * MB_C + 8;
constexpr int MB_LDE = MB_KEEP + 8, MB_LDEN = MB_LK + 8;
constexpr int MB_X = PASS_ROWS * MB_LDX;       // one [32, C] buffer
// columns of a block's saved operand rows (save_rows; wgrad_block's
// inputs): proj's input and d(out); the pooled rows and d(kv); xn and dq
constexpr int MB_OP_ATT = 0, MB_OP_DO = MB_C, MB_OP_POOL = 2 * MB_C;
constexpr int MB_OP_DKV = 3 * MB_C, MB_OP_XS = 5 * MB_C, MB_OP_DQ = 6 * MB_C;
constexpr int MB_OPW = 7 * MB_C;
constexpr int MB_RING = 3 * RING_KS * MB_LDX;  // three weight slices
constexpr int MB_BF16 = 2 * MB_S * MB_LDX      // bank k, v
                        + 2 * MB_LK * MB_LDE   // E_k^T, E_v^T
                        + 2 * MB_KEEP * MB_LDEN  // E_k, E_v
                        + PASS_ROWS * MB_LDKV  // kv, then d(kv)
                        + 11 * MB_X + MB_RING;
constexpr int MB_SMEM_BYTES = 2 * MB_BF16 + MB_KEEP * MB_KEEP * 4;

// per block: the operand rows (bf16) of its samples in passes of two
__host__ __device__ inline int msda_bwd_mma_scratch_floats(const Dims& d) {
  const int nb = (d.B + d.grid - 1) / d.grid;
  return PASS_ROWS * ((nb + 1) / 2) * MB_OPW / 2;
}

// One block per SM walks its samples in passes of two (an odd last pass
// runs a sample of zeros with a zero cotangent, which adds nothing).  The
// [32, C] buffers of a pass:
//   xs    xn
//   kc    [sample][k, v] the compressed keys [32, C]; then d(kc), d(vc)
//   q     q
//   att   the attention rows; then d(att)
//   dO    d(out) through the proj dropout
//   dq    the pooled rows; then d(q)
//   ds    dS
//   pu    the probabilities PV used; then d(pooled)
// and kv [32, 2C]: k | v of each sample's pooled rows (padded to 16),
// then d(kv).  The operand rows of the weight gradients go to the
// block's scratch (MB_OP_*).
__global__ void __launch_bounds__(NTHREADS, 1)
    msda_bwd_mma_kernel(MsdaBwdMmaArgs m) {
  QV_SMEM_DECL
  const MsdaBwdArgs& a = m.a;
  const MsdaArgs& f = a.f;
  const Dims& d = f.d;
  const MsdaGrads& gr = a.g;
  const int S = d.bank_s, keep = d.msda_keep, C = MB_C, kvn = MB_LK + S;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  bf16* bk = reinterpret_cast<bf16*>(qv_smem);
  bf16* bv = bk + MB_S * MB_LDX;
  bf16* et = bv + MB_S * MB_LDX;         // [2][MB_LK][MB_LDE]
  bf16* en = et + 2 * MB_LK * MB_LDE;    // [2][MB_KEEP][MB_LDEN]
  bf16* kv = en + 2 * MB_KEEP * MB_LDEN;
  bf16* xs = kv + PASS_ROWS * MB_LDKV;
  bf16* kc = xs + MB_X;                  // [2][2][32][MB_LDX]
  bf16* q = kc + 4 * MB_X;
  bf16* att = q + MB_X;
  bf16* dO = att + MB_X;
  bf16* dq = dO + MB_X;
  bf16* ds = dq + MB_X;
  bf16* pu = ds + MB_X;
  bf16* ring = pu + MB_X;
  float* sel = reinterpret_cast<float*>(ring + MB_RING);  // [16][16]
  const bf16 zero = from_f<bf16>(0.f);
  const bool zero_attn = d.guard && a.c.flag[1] != 0;
  float* gqkv_w = slice(gr.qkv_w, a.c);
  float* gqkv_b = slice(gr.qkv_b, a.c);
  auto kcv = [&](int s, int w) { return kc + (2 * s + w) * MB_X; };
  bf16* ops = reinterpret_cast<bf16*>(
      a.c.scratch + (size_t)blockIdx.x * msda_bwd_mma_scratch_floats(d));

  // per block: the bank rows rounded (rows past S zero), E^T and E
  // rounded (past msda_keep zero), the pooling matrix rounded
  for (int i = threadIdx.x; i < MB_S * C; i += blockDim.x) {
    const int r = i / C, c = i - r * C;
    bk[r * MB_LDX + c] = from_f<bf16>(r < S ? rnd<bf16>(f.bank_k[i]) : 0.f);
    bv[r * MB_LDX + c] = from_f<bf16>(r < S ? rnd<bf16>(f.bank_v[i]) : 0.f);
  }
  for (int i = threadIdx.x; i < 2 * MB_LK * MB_KEEP; i += blockDim.x) {
    const int w = i / (MB_LK * MB_KEEP), r = i - w * MB_LK * MB_KEEP;
    const int mr = r / MB_KEEP, k = r - mr * MB_KEEP;
    const float* e = w ? f.e_v : f.e_k;
    const bf16 v = k < keep ? from_f<bf16>(rnd<bf16>(e[k * MB_LK + mr]))
                            : zero;
    et[(w * MB_LK + mr) * MB_LDE + k] = v;
    en[(w * MB_KEEP + k) * MB_LDEN + mr] = v;
  }
  for (int i = threadIdx.x; i < NT * MB_KEEP; i += blockDim.x) {
    const int n = i / MB_KEEP, p = i - n * MB_KEEP;
    sel[i] = p < keep ? rnd<bf16>(f.sel_t[n * keep + p]) : 0.f;
  }

  // rows of sample slot s (< ns) from src, zeros past ns
  auto stage = [&](bf16* dst, const void* src, const int (&bs)[2], int ns) {
    for (int i = threadIdx.x; i < PASS_ROWS * (C / 8); i += blockDim.x) {
      const int r = i / (C / 8), c = (i - r * (C / 8)) * 8, s = r >> 4;
      bf16* to = dst + r * MB_LDX + c;
      if (s < ns)
        cp_async_16(to, static_cast<const bf16*>(src) +
                            ((size_t)bs[s] * NT + (r & 15)) * C + c);
      else
        *reinterpret_cast<uint4*>(to) = uint4{0u, 0u, 0u, 0u};
    }
  };
  const int nb = (d.B - (int)blockIdx.x + (int)gridDim.x - 1) / gridDim.x;
  for (int k0 = 0; k0 < nb; k0 += 2) {
    const int ns = nb - k0 < 2 ? nb - k0 : 2;
    const int bs[2] = {(int)blockIdx.x + k0 * (int)gridDim.x,
                       (int)blockIdx.x + (k0 + 1) * (int)gridDim.x};
    bf16* op = ops + (size_t)(k0 / 2) * PASS_ROWS * MB_OPW;  // pass's rows
    // the flat token index of the pass's row r (the samples by a select:
    // an index into bs would go to memory)
    auto tok = [&](int r) { return (r >> 4 ? bs[1] : bs[0]) * NT + (r & 15); };
    stage(xs, f.xn, bs, ns);
    stage(dO, a.d_out, bs, ns);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    // d(out) through the proj dropout
    if (d.train && d.drop_on)
      for (int i = threadIdx.x; i < PASS_ROWS * C; i += blockDim.x) {
        const int r = i / C, c = i - r * C;
        bf16* p = dO + r * MB_LDX + c;
        *p = from_f<bf16>(drop(d, MSDA_PROJ, (unsigned)(tok(r) * C + c),
                               to_f<bf16>(*p)));
      }
    if (zero_attn) {
      // a guarded branch: no gradient passes through its attention, so
      // only proj's bias learns (its input is zero) and d(xn) is zero
      for (int i = threadIdx.x; i < PASS_ROWS * MB_LDX; i += blockDim.x)
        att[i] = zero;
      __syncthreads();
      save_rows(op + MB_OP_ATT, MB_OPW, att, MB_LDX, C);
      save_rows(op + MB_OP_DO, MB_OPW, dO, MB_LDX, C);
      for (int i = threadIdx.x; i < ns * NT * (C / 8); i += blockDim.x) {
        const int r = i / (C / 8), c = (i - r * (C / 8)) * 8;
        *reinterpret_cast<uint4*>(static_cast<bf16*>(a.d_xn) +
                                  (size_t)tok(r) * C + c) =
            uint4{0u, 0u, 0u, 0u};
      }
      __syncthreads();
      continue;
    }
    // ---- recompute ---------------------------------------------------
    // the pooled rows (each sample's keep rows padded to 16) into dq
    for (int i = threadIdx.x; i < PASS_ROWS * C; i += blockDim.x) {
      const int r = i / C, c = i - r * C, s = r >> 4, p = r & 15;
      float acc = 0.f;
      if (p < keep)
        for (int n = 0; n < NT; ++n)
          acc = fmaf(sel[n * MB_KEEP + p],
                     to_f<bf16>(xs[(16 * s + n) * MB_LDX + c]), acc);
      dq[r * MB_LDX + c] = from_f<bf16>(acc);
    }
    __syncthreads();
    save_rows(op + MB_OP_POOL, MB_OPW, dq, MB_LDX, C);
    for (int w = 0; w < 2; ++w)   // kv = pooled @ W_kv + b, k then v
      gemm_pass<192, 3>(dq, MB_LDX, m.w + MB_QKV + (1 + w) * C, 3 * C, C,
                        ring, [&](int r, int c, float v0, float v1) {
                          const float* b = f.qkv_b + (1 + w) * C;
                          store_bf16x2(kv + r * MB_LDKV + w * C + c,
                                       pack_bf16x2(dense_out(v0, b[c]),
                                                   dense_out(v1, b[c + 1])));
                        });
    gemm_pass<192, 3>(xs, MB_LDX, m.w + MB_QKV, 3 * C, C, ring,
                      [&](int r, int c, float v0, float v1) {
                        store_bf16x2(q + r * MB_LDX + c,
                                     pack_bf16x2(dense_out(v0, f.qkv_b[c]),
                                                 dense_out(v1,
                                                           f.qkv_b[c + 1])));
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
      load_a(af, et + (w * MB_LK + mt * 16) * MB_LDE, MB_LDE, lane);
#pragma unroll
      for (int np = 0; np < 6; ++np) {
        unsigned bf[4];
        load_b_kn(bf, kv + 16 * s * MB_LDKV + w * C + ch * 96 + 16 * np,
                  MB_LDKV, lane);
        mma_bf16_16816(acc[2 * np], af, bf);
        mma_bf16_16816(acc[2 * np + 1], af, bf + 2);
      }
#pragma unroll
      for (int j = 0; j < 12; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          store_bf16x2(kcv(s, w) + (mt * 16 + g + 8 * hf) * MB_LDX +
                           ch * 96 + 8 * j + 2 * t,
                       pack_bf16x2(acc[j][2 * hf], acc[j][2 * hf + 1]));
    }
    __syncthreads();
    // the attention: warp (sample s, head h), 32 compressed + S bank keys
    const int s = warp >> 2, h = warp & 3, hc = h * ATT_D;
    const AttnMask am{attn_drop(d, MSDA_ATTN),
                      (unsigned)bs[s] * MB_H * NT * kvn, h, kvn};
    const bf16* const kt[3] = {kcv(s, 0), kcv(s, 0) + 16 * MB_LDX, bk};
    const bf16* const vt[3] = {kcv(s, 1), kcv(s, 1) + 16 * MB_LDX, bv};
    unsigned qa[3][4];
#pragma unroll
    for (int ks = 0; ks < 3; ++ks)
      load_a(qa[ks], q + 16 * s * MB_LDX + hc + 16 * ks, MB_LDX, lane);
    warp_attention_train<3>(qa, kt, vt, MB_LDX, hc, kvn, am,
                            att + 16 * s * MB_LDX, MB_LDX);
    __syncthreads();
    // ---- proj --------------------------------------------------------
    save_rows(op + MB_OP_ATT, MB_OPW, att, MB_LDX, C);
    save_rows(op + MB_OP_DO, MB_OPW, dO, MB_LDX, C);
    gemm_pass<192, 3>(dO, MB_LDX, m.w + MB_PROJT, C, C, ring,
                      [&](int r, int c, float v0, float v1) {
                        store_bf16x2(att + r * MB_LDX + c,
                                     pack_bf16x2(v0, v1));
                      });
    __syncthreads();
    // ---- attention: dq, dS, P; this warp's d(kc), d(vc) in place -------
#pragma unroll
    for (int ks = 0; ks < 3; ++ks)
      load_a(qa[ks], q + 16 * s * MB_LDX + hc + 16 * ks, MB_LDX, lane);
    warp_attention_bwd<3>(qa, kt, vt, MB_LDX, hc, kvn, am,
                          att + 16 * s * MB_LDX, MB_LDX,
                          dq + 16 * s * MB_LDX, MB_LDX,
                          ds + 16 * s * MB_LDX + hc, pu + 16 * s * MB_LDX + hc,
                          MB_LDX);
    __syncwarp();
    for (int w = 0; w < 2; ++w)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        float acc[3][2][4];
        key_grads<1>((w ? pu : ds) + 16 * s * MB_LDX + hc + 16 * mt, MB_LDX,
                     (w ? att : q) + 16 * s * MB_LDX + hc, MB_LDX, acc);
#pragma unroll
        for (int c3 = 0; c3 < 3; ++c3)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf)
              store_bf16x2(kcv(s, w) + (16 * mt + g + 8 * hf) * MB_LDX + hc +
                               16 * c3 + 8 * j + 2 * t,
                           pack_bf16x2(acc[c3][j][2 * hf],
                                       acc[c3][j][2 * hf + 1]));
      }
    __syncthreads();
    {  // the bank keys: warp (k or v, head), summed over the pass's rows
      const int w = warp >> 2, hb = (warp & 3) * ATT_D;
      float acc[3][2][4];
      key_grads<2>((w ? pu : ds) + hb + MB_LK, MB_LDX, (w ? att : q) + hb,
                   MB_LDX, acc);
      float* gb = slice(w ? gr.bank_v : gr.bank_k, a.c);
#pragma unroll
      for (int c3 = 0; c3 < 3; ++c3)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = g + 8 * (e >> 1);
            if (key < S)
              gb[key * C + hb + 16 * c3 + 8 * j + 2 * t + (e & 1)] +=
                  acc[c3][j][e];
          }
    }
    // ---- the Linformer mix -------------------------------------------
    if (warp < 4) {  // d(E)[n, m] = sum_c k[n, c] d(kc)[m, c]: (k or v,
                     // 16 of the 32 m), summed over the pass's samples
      const int w = warp >> 1, m0 = 16 * (warp & 1);
      float acc[2][4] = {};
      for (int s2 = 0; s2 < ns; ++s2)
#pragma unroll
        for (int ks = 0; ks < C / 16; ++ks) {
          unsigned af[4], bf[4];
          load_a(af, kv + 16 * s2 * MB_LDKV + w * C + 16 * ks, MB_LDKV,
                 lane);
          load_b_nk(bf, kcv(s2, w) + m0 * MB_LDX + 16 * ks, MB_LDX, lane);
          mma_bf16_16816(acc[0], af, bf);
          mma_bf16_16816(acc[1], af, bf + 2);
        }
      float* ge = slice(w ? gr.e_v : gr.e_k, a.c);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = g + 8 * (e >> 1);
          if (n < keep)
            ge[n * MB_LK + m0 + 8 * j + 2 * t + (e & 1)] += acc[j][e];
        }
    }
    __syncthreads();
    {  // d(k | v)[n, c] = sum_m E[n, m] d(kc | vc)[m, c] into kv: warp
       // (sample, k or v, 96-column half); rows past keep are zero
      const int s2 = warp >> 2, w = (warp >> 1) & 1, ch = warp & 1;
      float acc[12][4];
#pragma unroll
      for (int j = 0; j < 12; ++j)
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        unsigned af[4];
        load_a(af, en + w * MB_KEEP * MB_LDEN + 16 * ks, MB_LDEN, lane);
#pragma unroll
        for (int np = 0; np < 6; ++np) {
          unsigned bf[4];
          load_b_kn(bf, kcv(s2, w) + 16 * ks * MB_LDX + ch * 96 + 16 * np,
                    MB_LDX, lane);
          mma_bf16_16816(acc[2 * np], af, bf);
          mma_bf16_16816(acc[2 * np + 1], af, bf + 2);
        }
      }
#pragma unroll
      for (int j = 0; j < 12; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          store_bf16x2(kv + (16 * s2 + g + 8 * hf) * MB_LDKV + w * C +
                           ch * 96 + 8 * j + 2 * t,
                       pack_bf16x2(acc[j][2 * hf], acc[j][2 * hf + 1]));
    }
    __syncthreads();
    // ---- the qkv kernel: d(pooled), d(xn) ------------------------------
    save_rows(op + MB_OP_DKV, MB_OPW, kv, MB_LDKV, 2 * C);
    save_rows(op + MB_OP_XS, MB_OPW, xs, MB_LDX, C);
    save_rows(op + MB_OP_DQ, MB_OPW, dq, MB_LDX, C);
    gemm_pass<192, 3>(kv, MB_LDKV, m.w + MB_QKVT + C * C, C, 2 * C, ring,
                      [&](int r, int c, float v0, float v1) {
                        store_bf16x2(pu + r * MB_LDX + c,
                                     pack_bf16x2(v0, v1));
                      });
    gemm_pass<192, 3>(dq, MB_LDX, m.w + MB_QKVT, C, C, ring,
                      [&](int r, int c, float v0, float v1) {
                        const int s2 = r >> 4, n = r & 15;
                        if (s2 >= ns) return;
                        for (int p = 0; p < keep; ++p) {
                          const float w = sel[n * MB_KEEP + p];
                          const bf16* dp = pu + (16 * s2 + p) * MB_LDX + c;
                          v0 = fmaf(w, to_f<bf16>(dp[0]), v0);
                          v1 = fmaf(w, to_f<bf16>(dp[1]), v1);
                        }
                        store_bf16x2(static_cast<bf16*>(a.d_xn) +
                                         (size_t)tok(r) * C + c,
                                     pack_bf16x2(v0, v1));
                      });
    __syncthreads();
  }
  // the weight gradients over every row of the block, each stored once
  // into the slice (the guarded branch's qkv ones stay zero)
  auto wgrad = [&](int ao, int K, int bo, int N, float* w, float* bias,
                   int ldg) {
    wgrad_block(ops + ao, ops + bo, MB_OPW, PASS_ROWS * ((nb + 1) / 2), K, N,
                w, ldg, bias, reinterpret_cast<bf16*>(qv_smem), MB_BF16);
  };
  wgrad(MB_OP_ATT, C, MB_OP_DO, C, slice(gr.proj_w, a.c),
        slice(gr.proj_b, a.c), C);
  if (zero_attn) return;
  wgrad(MB_OP_POOL, C, MB_OP_DKV, 2 * C, gqkv_w + C, gqkv_b + C, 3 * C);
  wgrad(MB_OP_XS, C, MB_OP_DQ, C, gqkv_w, gqkv_b, 3 * C);
}

// --- bf16 at hqavit_tiny_in's widths, n = 64: msda_bwd_mma64_kernel ----------
//
// A sample's 64 queries attend to its 32 compressed keys and the bank's,
// and the compressed keys mix all 40 pooled rows of the sample, so a pass
// is one sample: its pooled rows (48, padded), kv and kc | vc stay
// resident while the queries run in two halves of 32 rows through the n =
// 16 design's steps (q, the attention with its dropout replayed, proj's
// d(att), warp_attention_bwd); each warp (k or v, head) sums its keys'
// d(kc), d(vc) and the bank keys' over both halves in float32 registers.
// Then the Linformer backward (d(E), d(k | v) = E @ d(kc | vc)), d(pooled)
// = d(kv) @ W_kv^T, and per half d(xn) = dq @ W_q^T + sel_t d(pooled), the
// halves' dq read back from the block's operand rows.  The pooled rows are
// made from device memory (xn) by each pooled row's non-zeros in token
// order, as the forward's gather (a NaN in xn trips the guard, whose
// branch reads no pooled row).  The operand rows of the weight gradients
// go to the block's scratch: 64 rows a sample of proj's input, d(out), xn
// and dq; 48 of the pooled rows and d(kv).

// the geometry msda_bwd_mma64_kernel is written for
// (fused_kernels.msda_bwd_mma_error)
constexpr int M6_N = 64, M6_KEEP = 48, M6_POOL = 8;
constexpr int M6_LDE = M6_KEEP + 8, M6_LDS = M6_KEEP + 8;
constexpr int M6_X = PASS_ROWS * MB_LDX;       // one [32, C] buffer
// columns of a sample's saved operand rows: per query row proj's input
// and d(out), xn and dq; per pooled row the pooled row and d(kv)
constexpr int M6_OP_ATT = 0, M6_OP_DO = MB_C, M6_OP_XS = 2 * MB_C;
constexpr int M6_OP_DQ = 3 * MB_C, M6_OPW = 4 * MB_C;
constexpr int M6_OP_POOL = 0, M6_OP_DKV = MB_C, M6_OPPW = 3 * MB_C;
constexpr int M6_OPS = M6_N * M6_OPW + M6_KEEP * M6_OPPW;  // a sample's
constexpr int M6_BF16 = 2 * MB_S * MB_LDX      // bank k, v
                        + 2 * MB_LK * M6_LDE   // E_k^T, E_v^T
                        + 2 * M6_KEEP * MB_LDEN  // E_k, E_v
                        + M6_N * M6_LDS        // sel_t rounded
                        + M6_KEEP * MB_LDKV    // kv, then d(kv)
                        + 4 * MB_LK * MB_LDX / 2  // kc, vc; d(kc), d(vc)
                        + 7 * M6_X + MB_RING;
constexpr int M6_SMEM_BYTES = 2 * M6_BF16 + M6_KEEP * (1 + 2 * M6_POOL) * 4;
static_assert(2 * M6_X >= M6_KEEP * MB_LDX, "the pooled rows in q | att");

// per block: the operand rows (bf16) of its samples
__host__ __device__ inline int msda_bwd_mma64_scratch_floats(const Dims& d) {
  return (d.B + d.grid - 1) / d.grid * M6_OPS / 2;
}

// The buffers: xs (a half's xn), q, att (the attention rows, then
// d(att)), dO (d(out) through the proj dropout), dq, ds (dS), pu (the
// probabilities PV used), each [32, C]; the pooled rows, later d(pooled),
// in q | att's space ([48, C]); kv [48, 2C] (k | v, then d(kv)); kc | vc
// [2][32, C] (then d(kc) | d(vc)).
__global__ void __launch_bounds__(NTHREADS, 1)
    msda_bwd_mma64_kernel(MsdaBwdMmaArgs m) {
  QV_SMEM_DECL
  const MsdaBwdArgs& a = m.a;
  const MsdaArgs& f = a.f;
  const Dims& d = f.d;
  const MsdaGrads& gr = a.g;
  const int S = d.bank_s, keep = d.msda_keep, C = MB_C, kvn = MB_LK + S;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  bf16* bk = reinterpret_cast<bf16*>(qv_smem);
  bf16* bv = bk + MB_S * MB_LDX;
  bf16* et = bv + MB_S * MB_LDX;         // [2][MB_LK][M6_LDE]
  bf16* en = et + 2 * MB_LK * M6_LDE;    // [2][M6_KEEP][MB_LDEN]
  bf16* selb = en + 2 * M6_KEEP * MB_LDEN;  // [M6_N][M6_LDS]
  bf16* kv = selb + M6_N * M6_LDS;       // [M6_KEEP][MB_LDKV]
  bf16* kc = kv + M6_KEEP * MB_LDKV;     // [2][MB_LK][MB_LDX]
  bf16* xs = kc + 2 * MB_LK * MB_LDX;
  bf16* q = xs + M6_X;
  bf16* att = q + M6_X;
  bf16* pl = q;                          // [M6_KEEP][MB_LDX]
  bf16* dO = att + M6_X;
  bf16* dq = dO + M6_X;
  bf16* ds = dq + M6_X;
  bf16* pu = ds + M6_X;
  bf16* ring = pu + M6_X;
  int* pool_n = reinterpret_cast<int*>(ring + MB_RING);
  int* pool_src = pool_n + M6_KEEP;      // [M6_KEEP][M6_POOL]
  float* pool_w = reinterpret_cast<float*>(pool_src + M6_KEEP * M6_POOL);
  const bf16 zero = from_f<bf16>(0.f);
  const bool zero_attn = d.guard && a.c.flag[1] != 0;
  float* gqkv_w = slice(gr.qkv_w, a.c);
  float* gqkv_b = slice(gr.qkv_b, a.c);
  auto kcv = [&](int w) { return kc + w * MB_LK * MB_LDX; };
  const int nb = (d.B - (int)blockIdx.x + (int)gridDim.x - 1) / gridDim.x;
  bf16* ops = reinterpret_cast<bf16*>(
      a.c.scratch + (size_t)blockIdx.x * msda_bwd_mma64_scratch_floats(d));
  bf16* opq = ops;                                  // [nb * 64][M6_OPW]
  bf16* opp = ops + (size_t)nb * M6_N * M6_OPW;     // [nb * 48][M6_OPPW]

  // per block: the bank rows rounded (rows past S zero), E^T and E
  // rounded (past msda_keep zero), the pooling matrix rounded, and each
  // pooled row's non-zeros in token order
  for (int i = threadIdx.x; i < MB_S * C; i += blockDim.x) {
    const int r = i / C, c = i - r * C;
    bk[r * MB_LDX + c] = from_f<bf16>(r < S ? rnd<bf16>(f.bank_k[i]) : 0.f);
    bv[r * MB_LDX + c] = from_f<bf16>(r < S ? rnd<bf16>(f.bank_v[i]) : 0.f);
  }
  for (int i = threadIdx.x; i < 2 * MB_LK * M6_KEEP; i += blockDim.x) {
    const int w = i / (MB_LK * M6_KEEP), r = i - w * MB_LK * M6_KEEP;
    const int mr = r / M6_KEEP, k = r - mr * M6_KEEP;
    const float* e = w ? f.e_v : f.e_k;
    const bf16 v = k < keep ? from_f<bf16>(rnd<bf16>(e[k * MB_LK + mr]))
                            : zero;
    et[(w * MB_LK + mr) * M6_LDE + k] = v;
    en[(w * M6_KEEP + k) * MB_LDEN + mr] = v;
  }
  for (int i = threadIdx.x; i < M6_N * M6_KEEP; i += blockDim.x) {
    const int n = i / M6_KEEP, p = i - n * M6_KEEP;
    selb[n * M6_LDS + p] =
        from_f<bf16>(p < keep ? rnd<bf16>(f.sel_t[n * keep + p]) : 0.f);
  }
  if ((int)threadIdx.x < keep) {
    const int p = threadIdx.x;
    int cnt = 0;
    for (int n = 0; n < M6_N; ++n) {
      const float w = f.sel_t[n * keep + p];
      if (w != 0.f && cnt < M6_POOL) {
        pool_src[p * M6_POOL + cnt] = n;
        pool_w[p * M6_POOL + cnt] = rnd<bf16>(w);
        ++cnt;
      }
    }
    pool_n[p] = cnt;
  }
  __syncthreads();

  for (int k0 = 0; k0 < nb; ++k0) {
    const int b = (int)blockIdx.x + k0 * (int)gridDim.x;
    const bf16* xn = static_cast<const bf16*>(f.xn) + (size_t)b * M6_N * C;
    bf16* oq = opq + (size_t)k0 * M6_N * M6_OPW;     // the sample's rows
    bf16* op = opp + (size_t)k0 * M6_KEEP * M6_OPPW;
    // rows 32 hq.. of the sample's src into dst
    auto stage = [&](bf16* dst, const void* src, int hq) {
      const bf16* from = static_cast<const bf16*>(src) +
                         ((size_t)b * M6_N + PASS_ROWS * hq) * C;
      for (int i = threadIdx.x; i < PASS_ROWS * (C / 8); i += blockDim.x) {
        const int r = i / (C / 8), c = (i - r * (C / 8)) * 8;
        cp_async_16(dst + r * MB_LDX + c, from + (size_t)r * C + c);
      }
    };
    // d(out) of half hq through the proj dropout into dO
    auto stage_dout = [&](int hq) {
      stage(dO, a.d_out, hq);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      if (d.train && d.drop_on)
        for (int i = threadIdx.x; i < PASS_ROWS * C; i += blockDim.x) {
          const int r = i / C, c = i - r * C;
          bf16* p = dO + r * MB_LDX + c;
          *p = from_f<bf16>(drop(
              d, MSDA_PROJ,
              (unsigned)(((size_t)b * M6_N + PASS_ROWS * hq + r) * C + c),
              to_f<bf16>(*p)));
        }
      __syncthreads();
    };
    if (zero_attn) {
      // a guarded branch: no gradient passes through its attention, so
      // only proj's bias learns (its input is zero) and d(xn) is zero
      for (int hq = 0; hq < 2; ++hq) {
        stage_dout(hq);
        for (int i = threadIdx.x; i < M6_X; i += blockDim.x) att[i] = zero;
        __syncthreads();
        save_rows(oq + PASS_ROWS * hq * M6_OPW + M6_OP_ATT, M6_OPW, att,
                  MB_LDX, C);
        save_rows(oq + PASS_ROWS * hq * M6_OPW + M6_OP_DO, M6_OPW, dO,
                  MB_LDX, C);
        for (int i = threadIdx.x; i < PASS_ROWS * (C / 8); i += blockDim.x) {
          const int r = i / (C / 8), c = (i - r * (C / 8)) * 8;
          *reinterpret_cast<uint4*>(
              static_cast<bf16*>(a.d_xn) +
              ((size_t)b * M6_N + PASS_ROWS * hq + r) * C + c) =
              uint4{0u, 0u, 0u, 0u};
        }
        __syncthreads();
      }
      continue;
    }
    // ---- recompute: the pooled rows, kv, kc | vc ----------------------
    for (int i = threadIdx.x; i < M6_KEEP * C; i += blockDim.x) {
      const int p = i / C, c = i - p * C;
      float acc = 0.f;
      if (p < keep)
        for (int j = 0; j < pool_n[p]; ++j)
          acc = fmaf(pool_w[p * M6_POOL + j],
                     to_f<bf16>(xn[(size_t)pool_src[p * M6_POOL + j] * C + c]),
                     acc);
      pl[p * MB_LDX + c] = from_f<bf16>(acc);
    }
    __syncthreads();
    save_rows(op + M6_OP_POOL, M6_OPPW, pl, MB_LDX, C, M6_KEEP);
    for (int r0 = 0; r0 < M6_KEEP; r0 += PASS_ROWS)
      for (int w = 0; w < 2; ++w)   // kv = pooled @ W_kv + b, k then v
        gemm_pass<192, 3>(pl + r0 * MB_LDX, MB_LDX,
                          m.w + MB_QKV + (1 + w) * C, 3 * C, C, ring,
                          [&](int r, int c, float v0, float v1) {
                            if (r0 + r >= M6_KEEP) return;
                            const float* bb = f.qkv_b + (1 + w) * C;
                            store_bf16x2(kv + (r0 + r) * MB_LDKV + w * C + c,
                                         pack_bf16x2(dense_out(v0, bb[c]),
                                                     dense_out(v1,
                                                               bb[c + 1])));
                          });
    __syncthreads();
    {  // kc | vc = rnd(E^T @ k | v): warp (k or v, 16-key tile, 96-column
       // half)
      const int w = warp >> 2, mt = (warp >> 1) & 1, ch = warp & 1;
      float acc[12][4];
#pragma unroll
      for (int j = 0; j < 12; ++j)
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < M6_KEEP / 16; ++ks) {
        unsigned af[4];
        load_a(af, et + (w * MB_LK + mt * 16) * M6_LDE + 16 * ks, M6_LDE,
               lane);
#pragma unroll
        for (int np = 0; np < 6; ++np) {
          unsigned bf[4];
          load_b_kn(bf, kv + 16 * ks * MB_LDKV + w * C + ch * 96 + 16 * np,
                    MB_LDKV, lane);
          mma_bf16_16816(acc[2 * np], af, bf);
          mma_bf16_16816(acc[2 * np + 1], af, bf + 2);
        }
      }
#pragma unroll
      for (int j = 0; j < 12; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          store_bf16x2(kcv(w) + (mt * 16 + g + 8 * hf) * MB_LDX + ch * 96 +
                           8 * j + 2 * t,
                       pack_bf16x2(acc[j][2 * hf], acc[j][2 * hf + 1]));
    }
    __syncthreads();
    // this warp's key gradients, summed over both halves: warp (k or v,
    // head h), its 32 compressed keys and the bank's 16 (key tile kt)
    const int kw = warp >> 2, kh = (warp & 3) * ATT_D;
    float kacc[3][3][2][4];
#pragma unroll
    for (int kt = 0; kt < 3; ++kt)
#pragma unroll
      for (int c3 = 0; c3 < 3; ++c3)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) kacc[kt][c3][j][e] = 0.f;
    // ---- the query halves ---------------------------------------------
    for (int hq = 0; hq < 2; ++hq) {
      bf16* oh = oq + PASS_ROWS * hq * M6_OPW;      // the half's rows
      stage(xs, f.xn, hq);
      stage_dout(hq);
      gemm_pass<192, 3>(xs, MB_LDX, m.w + MB_QKV, 3 * C, C, ring,
                        [&](int r, int c, float v0, float v1) {
                          store_bf16x2(q + r * MB_LDX + c,
                                       pack_bf16x2(dense_out(v0, f.qkv_b[c]),
                                                   dense_out(v1,
                                                             f.qkv_b[c + 1])));
                        });
      __syncthreads();
      // the attention: warp (16-query tile s, head h)
      const int s = warp >> 2, h = warp & 3, hc = h * ATT_D;
      const AttnMask am{attn_drop(d, MSDA_ATTN),
                        (unsigned)(b * MB_H * M6_N + PASS_ROWS * hq + 16 * s) *
                            kvn,
                        h, kvn, M6_N};
      const bf16* const kt[3] = {kcv(0), kcv(0) + 16 * MB_LDX, bk};
      const bf16* const vt[3] = {kcv(1), kcv(1) + 16 * MB_LDX, bv};
      unsigned qa[3][4];
#pragma unroll
      for (int ks = 0; ks < 3; ++ks)
        load_a(qa[ks], q + 16 * s * MB_LDX + hc + 16 * ks, MB_LDX, lane);
      warp_attention_train<3>(qa, kt, vt, MB_LDX, hc, kvn, am,
                              att + 16 * s * MB_LDX, MB_LDX);
      __syncthreads();
      // ---- proj ------------------------------------------------------
      save_rows(oh + M6_OP_ATT, M6_OPW, att, MB_LDX, C);
      save_rows(oh + M6_OP_DO, M6_OPW, dO, MB_LDX, C);
      gemm_pass<192, 3>(dO, MB_LDX, m.w + MB_PROJT, C, C, ring,
                        [&](int r, int c, float v0, float v1) {
                          store_bf16x2(att + r * MB_LDX + c,
                                       pack_bf16x2(v0, v1));
                        });
      __syncthreads();
      // ---- attention: dq, dS, P ----------------------------------------
#pragma unroll
      for (int ks = 0; ks < 3; ++ks)
        load_a(qa[ks], q + 16 * s * MB_LDX + hc + 16 * ks, MB_LDX, lane);
      warp_attention_bwd<3>(qa, kt, vt, MB_LDX, hc, kvn, am,
                            att + 16 * s * MB_LDX, MB_LDX,
                            dq + 16 * s * MB_LDX, MB_LDX,
                            ds + 16 * s * MB_LDX + hc,
                            pu + 16 * s * MB_LDX + hc, MB_LDX);
      __syncthreads();
#pragma unroll
      for (int kt2 = 0; kt2 < 3; ++kt2) {
        float acc[3][2][4];
        key_grads<2>((kw ? pu : ds) + kh + 16 * kt2, MB_LDX,
                     (kw ? att : q) + kh, MB_LDX, acc);
#pragma unroll
        for (int c3 = 0; c3 < 3; ++c3)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) kacc[kt2][c3][j][e] += acc[c3][j][e];
      }
      save_rows(oh + M6_OP_XS, M6_OPW, xs, MB_LDX, C);
      save_rows(oh + M6_OP_DQ, M6_OPW, dq, MB_LDX, C);
      __syncthreads();
    }
    // ---- d(kc), d(vc) over kc | vc; the bank keys' into the slice -------
#pragma unroll
    for (int kt2 = 0; kt2 < 2; ++kt2)
#pragma unroll
      for (int c3 = 0; c3 < 3; ++c3)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
            store_bf16x2(kcv(kw) + (16 * kt2 + g + 8 * hf) * MB_LDX + kh +
                             16 * c3 + 8 * j + 2 * t,
                         pack_bf16x2(kacc[kt2][c3][j][2 * hf],
                                     kacc[kt2][c3][j][2 * hf + 1]));
    {
      float* gb = slice(kw ? gr.bank_v : gr.bank_k, a.c);
#pragma unroll
      for (int c3 = 0; c3 < 3; ++c3)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = g + 8 * (e >> 1);
            if (key < S)
              gb[key * C + kh + 16 * c3 + 8 * j + 2 * t + (e & 1)] +=
                  kacc[2][c3][j][e];
          }
    }
    __syncthreads();
    // ---- the Linformer mix ----------------------------------------------
    // d(E)[p, m] = sum_c k[p, c] d(kc)[m, c]: unit (k or v, 16 pooled
    // rows, 16 of the 32 m)
    for (int u = warp; u < 12; u += NTHREADS / 32) {
      const int w = u / 6, nt = (u % 6) >> 1, m0 = 16 * (u & 1);
      float acc[2][4] = {};
#pragma unroll 4
      for (int ks = 0; ks < C / 16; ++ks) {
        unsigned af[4], bf[4];
        load_a(af, kv + 16 * nt * MB_LDKV + w * C + 16 * ks, MB_LDKV, lane);
        load_b_nk(bf, kcv(w) + m0 * MB_LDX + 16 * ks, MB_LDX, lane);
        mma_bf16_16816(acc[0], af, bf);
        mma_bf16_16816(acc[1], af, bf + 2);
      }
      float* ge = slice(w ? gr.e_v : gr.e_k, a.c);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = 16 * nt + g + 8 * (e >> 1);
          if (n < keep)
            ge[n * MB_LK + m0 + 8 * j + 2 * t + (e & 1)] += acc[j][e];
        }
    }
    __syncthreads();
    // d(k | v)[p, c] = sum_m E[p, m] d(kc | vc)[m, c] into kv: unit (k or
    // v, 16 pooled rows, 96-column half); rows past keep are zero
    for (int u = warp; u < 12; u += NTHREADS / 32) {
      const int w = u / 6, nt = (u % 6) >> 1, ch = u & 1;
      float acc[12][4];
#pragma unroll
      for (int j = 0; j < 12; ++j)
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        unsigned af[4];
        load_a(af, en + (w * M6_KEEP + 16 * nt) * MB_LDEN + 16 * ks, MB_LDEN,
               lane);
#pragma unroll
        for (int np = 0; np < 6; ++np) {
          unsigned bf[4];
          load_b_kn(bf, kcv(w) + 16 * ks * MB_LDX + ch * 96 + 16 * np, MB_LDX,
                    lane);
          mma_bf16_16816(acc[2 * np], af, bf);
          mma_bf16_16816(acc[2 * np + 1], af, bf + 2);
        }
      }
#pragma unroll
      for (int j = 0; j < 12; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          store_bf16x2(kv + (16 * nt + g + 8 * hf) * MB_LDKV + w * C +
                           ch * 96 + 8 * j + 2 * t,
                       pack_bf16x2(acc[j][2 * hf], acc[j][2 * hf + 1]));
    }
    __syncthreads();
    // ---- the qkv kernel: d(pooled), then d(xn) a half at a time ----------
    save_rows(op + M6_OP_DKV, M6_OPPW, kv, MB_LDKV, 2 * C, M6_KEEP);
    for (int r0 = 0; r0 < M6_KEEP; r0 += PASS_ROWS)
      gemm_pass<192, 3>(kv + r0 * MB_LDKV, MB_LDKV, m.w + MB_QKVT + C * C, C,
                        2 * C, ring, [&](int r, int c, float v0, float v1) {
                          if (r0 + r < M6_KEEP)
                            store_bf16x2(pl + (r0 + r) * MB_LDX + c,
                                         pack_bf16x2(v0, v1));
                        });
    __syncthreads();
    for (int hq = 0; hq < 2; ++hq) {
      const bf16* dqs = oq + PASS_ROWS * hq * M6_OPW + M6_OP_DQ;
      for (int i = threadIdx.x; i < PASS_ROWS * (C / 8); i += blockDim.x) {
        const int r = i / (C / 8), c = (i - r * (C / 8)) * 8;
        cp_async_16(dq + r * MB_LDX + c, dqs + (size_t)r * M6_OPW + c);
      }
      cp_async_commit();       // gemm_pass's first wait completes it
      gemm_pass<192, 3>(dq, MB_LDX, m.w + MB_QKVT, C, C, ring,
                        [&](int r, int c, float v0, float v1) {
                          const int n = PASS_ROWS * hq + r;
                          for (int p = 0; p < keep; ++p) {
                            const float w = to_f<bf16>(selb[n * M6_LDS + p]);
                            const bf16* dp = pl + p * MB_LDX + c;
                            v0 = fmaf(w, to_f<bf16>(dp[0]), v0);
                            v1 = fmaf(w, to_f<bf16>(dp[1]), v1);
                          }
                          store_bf16x2(static_cast<bf16*>(a.d_xn) +
                                           ((size_t)b * M6_N + n) * C + c,
                                       pack_bf16x2(v0, v1));
                        });
      __syncthreads();
    }
  }
  // the weight gradients over every row of the block, each stored once
  // into the slice (the guarded branch's qkv ones stay zero)
  bf16* stage_smem = reinterpret_cast<bf16*>(qv_smem);
  wgrad_block(opq + M6_OP_ATT, opq + M6_OP_DO, M6_OPW, M6_N * nb, C, C,
              slice(gr.proj_w, a.c), C, slice(gr.proj_b, a.c), stage_smem,
              M6_BF16);
  if (zero_attn) return;
  wgrad_block(opp + M6_OP_POOL, opp + M6_OP_DKV, M6_OPPW, M6_KEEP * nb, C,
              2 * C, gqkv_w + C, 3 * C, gqkv_b + C, stage_smem, M6_BF16);
  wgrad_block(opq + M6_OP_XS, opq + M6_OP_DQ, M6_OPW, M6_N * nb, C, C,
              gqkv_w, 3 * C, gqkv_b, stage_smem, M6_BF16);
}

}  // namespace qv

// bf16 at hqavit_c100's widths: `a` as for qv_unit_msda_bwd with a
// per-block scratch of msda_bwd_mma_scratch_floats(d), the bf16 weights
// beside it (MsdaBwdMmaArgs).  ERR_ARGS for any other geometry
// or type (the wrapper checks them first, msda_bwd_mma_error).
extern "C" int qv_unit_msda_bwd_mma(const qv::MsdaBwdArgs* a, const void* w,
                                    int is_bf16, void* stream) {
  const qv::Dims& d = a->f.d;
  if (!is_bf16 || !d.train || d.n != qv::NT || d.nw != 1 ||
      d.c != qv::MB_C || d.heads != qv::MB_H || d.lin_k != qv::MB_LK ||
      d.bank_s > qv::MB_S || d.msda_keep > qv::MB_KEEP || d.grid > d.B)
    return qv::ERR_ARGS;
  const qv::MsdaBwdMmaArgs m{*a, static_cast<const qv::bf16*>(w)};
  const int rc = qv_launch(qv::msda_bwd_mma_kernel, m, qv::MB_SMEM_BYTES,
                           stream, d.grid);
  if (rc != 0) return rc;
  return qv_reduce(a->c.gws, a->c.grad, d.grid, a->c.wstride, d.rgrid, stream);
}

extern "C" int qv_unit_msda_bwd_mma_smem(const qv::Dims*) {
  return qv::MB_SMEM_BYTES;
}

extern "C" int qv_unit_msda_bwd_mma_scratch(const qv::Dims* d) {
  return qv::msda_bwd_mma_scratch_floats(*d);
}

// bf16 at hqavit_tiny_in's widths, n = 64 (msda_bwd_mma64_kernel): `a` as
// for qv_unit_msda_bwd with a per-block scratch of
// msda_bwd_mma64_scratch_floats(d), the bf16 weights beside it; the
// workspace `gws` zeroed.  ERR_ARGS for any other geometry or type (the
// wrapper checks them first, msda_bwd_mma_error).
extern "C" int qv_unit_msda_bwd_mma64(const qv::MsdaBwdArgs* a,
                                      const void* w, int is_bf16,
                                      void* stream) {
  const qv::Dims& d = a->f.d;
  if (!is_bf16 || !d.train || d.n != qv::M6_N || d.nw != 4 ||
      d.c != qv::MB_C || d.heads != qv::MB_H || d.lin_k != qv::MB_LK ||
      d.bank_s > qv::MB_S || d.msda_keep > qv::M6_KEEP || d.grid > d.B)
    return qv::ERR_ARGS;
  const qv::MsdaBwdMmaArgs m{*a, static_cast<const qv::bf16*>(w)};
  const int rc = qv_launch(qv::msda_bwd_mma64_kernel, m, qv::M6_SMEM_BYTES,
                           stream, d.grid);
  if (rc != 0) return rc;
  return qv_reduce(a->c.gws, a->c.grad, d.grid, a->c.wstride, d.rgrid, stream);
}

extern "C" int qv_unit_msda_bwd_mma64_smem(const qv::Dims*) {
  return qv::M6_SMEM_BYTES;
}

extern "C" int qv_unit_msda_bwd_mma64_scratch(const qv::Dims* d) {
  return qv::msda_bwd_mma64_scratch_floats(*d);
}
