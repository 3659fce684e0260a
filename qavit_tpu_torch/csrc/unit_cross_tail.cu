// Unit 4 of the fused block, eval forward: cross branch + block tail.
//
// Replaces the TPU unit qavit_tpu/kernels/fused_kernels.py
// make_cores.core_cross_tail (fused_cores.py:699 cross_bd, :779 tail_bd),
// run through fused_pallas.py:190-212 fwd_call.
//
// Per sample: cross-attention of the 16 tokens onto the bank (q = Dense
// 192 -> 192 on xn, bank K/V = Dense 192 -> 192 on the 16 slots,
// recomputed per block as in the TPU body), proj; then the tail:
// 4 x (LN + compress 192 -> 48), softmax fusion weights, bottleneck
// 192 -> 96 GELU -> 192, residual; norm2, CCF-FFN fc1 192 -> 96, GELU,
// LN, 3x3 depthwise correlation on the 4x4 grid with a zero halo
// (bias before the 0.1 scale), LN, fc2 96 -> 192, x gamma; residual.
//
// Bound on the H100 at B=1024 (bf16): five [B,16,192] inputs read and one
// written, 37.7 MB (~11 us at 3.35 TB/s), against ~8.5 GFLOP (~9 us): the
// bytes bound it.  One 256-thread block per sample reads each input once
// into shared memory (~120 KB, float32, above the 48 KB static limit, so
// the launch opts in to dynamic shared memory) and writes only y; no
// intermediate of the tail touches device memory.  It runs on the CUDA
// cores in float32 and is latency-bound for now.
#include "common.cuh"

namespace qv {

__host__ __device__ inline int cross_tail_smem_floats(const Dims& d) {
  const int c = d.c, s = d.bank_s;
  const int hid = d.ccf_hidden > d.bottleneck_hidden ? d.ccf_hidden
                                                     : d.bottleneck_hidden;
  return 6 * NT * c          // xn/branch, q/fused, att/xr, cross, y, tmp
         + 3 * s * c         // bank rows, projected bank k, v
         + NT * hid          // hidden activations
         + NT * hid          // dwconv output
         + ((d.heads * NT * s + 3) / 4) * 4
         + 2 * NT;           // LN stats
}

template <typename T>
__device__ void gelu_rows(float* p, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) p[i] = rnd<T>(gelu_f(p[i]));
}

template <typename T>
__device__ void cross_tail_sample(const CrossTailArgs& a, int b,
                                  bool zero_attn, float* sm, int* bad) {
  const Dims& d = a.d;
  const int c = d.c, s = d.bank_s, h = d.heads;
  const int hid_bn = d.bottleneck_hidden, hid = d.ccf_hidden, dc = d.d_c;
  const int hmax = hid > hid_bn ? hid : hid_bn;
  const size_t off = (size_t)b * NT * c;
  float* A = sm;               // xn, then each branch output
  float* Q = A + NT * c;       // cross q, then the fused concat
  float* R = Q + NT * c;       // attention output, then x + bottleneck
  float* X = R + NT * c;       // cross branch output
  float* Y = X + NT * c;       // working rows
  float* Z = Y + NT * c;       // working rows
  float* braw = Z + NT * c;
  float* kb = braw + s * c;
  float* vb = kb + s * c;
  float* H1 = vb + s * c;
  float* H2 = H1 + NT * hmax;
  float* sc = H2 + NT * hmax;
  float* stats = sc + ((h * NT * s + 3) / 4) * 4;

  // ---- cross branch --------------------------------------------------
  if (threadIdx.x == 0) *bad = 0;
  load_tile<T>(A, static_cast<const T*>(a.xn) + off, NT * c);
  load_rounded<T>(braw, a.bank_k, s * c);
  __syncthreads();
  dense_rows<T>(A, c, 0, NT, c, a.cq_w, c, a.cq_b, c, 1, Q, c);
  dense_rows<T>(braw, c, 0, s, c, a.ck_w, c, a.ck_b, c, 1, kb, c);
  __syncthreads();
  load_rounded<T>(braw, a.bank_v, s * c);
  __syncthreads();
  dense_rows<T>(braw, c, 0, s, c, a.cv_w, c, a.cv_b, c, 1, vb, c);
  __syncthreads();
  if (zero_attn) {
    fill(R, NT * c, 0.f);
    __syncthreads();
  } else {
    attention<T>(Q, c, NT, h, c / h, kb, vb, c, s, nullptr, nullptr, c, 0, h,
                 R, c, sc, bad, d.guard != 0);
  }
  dense_rows<T>(R, c, 0, NT, c, a.cp_w, c, a.cp_b, c, 1, X, c);
  __syncthreads();

  // ---- tail: per-branch LN + compress, softmax-weighted concat -------
  float w[4];
  {
    float m = a.fusion[0];
    for (int i = 1; i < 4; ++i) m = fmaxf(m, a.fusion[i]);
    float sum = 0.f;
    for (int i = 0; i < 4; ++i) {
      w[i] = expf(a.fusion[i] - m);
      sum += w[i];
    }
    for (int i = 0; i < 4; ++i) w[i] = w[i] / sum;
  }
  const void* branch[3] = {a.swa, a.msda, a.cga};
  for (int i = 0; i < 4; ++i) {
    if (i < 3) {
      load_tile<T>(A, static_cast<const T*>(branch[i]) + off, NT * c);
      __syncthreads();
    }
    layer_norm_rows<T>(i < 3 ? A : X, c, A, c, NT, c, a.norm_s[i],
                       a.norm_b[i], stats);
    dense_rows<T>(A, c, 0, NT, c, a.comp_w[i], dc, a.comp_b[i], dc, 1,
                  Q + i * dc, c);
    __syncthreads();
    for (int e = threadIdx.x; e < NT * dc; e += blockDim.x) {
      float* p = Q + (e / dc) * c + i * dc + (e % dc);
      *p = rnd<T>(*p * w[i]);
    }
    __syncthreads();
  }

  // ---- bottleneck MLP and the first residual -------------------------
  dense_rows<T>(Q, c, 0, NT, 4 * dc, a.bn1_w, hid_bn, a.bn1_b, hid_bn, 1,
                H1, hid_bn);
  __syncthreads();
  gelu_rows<T>(H1, NT * hid_bn);
  __syncthreads();
  dense_rows<T>(H1, hid_bn, 0, NT, hid_bn, a.bn2_w, c, a.bn2_b, c, 1, Y, c);
  load_tile<T>(R, static_cast<const T*>(a.x) + off, NT * c);
  __syncthreads();
  for (int e = threadIdx.x; e < NT * c; e += blockDim.x)
    R[e] = rnd<T>(R[e] + Y[e]);
  __syncthreads();

  // ---- CCF-FFN --------------------------------------------------------
  layer_norm_rows<T>(R, c, Y, c, NT, c, a.norm2_s, a.norm2_b, stats);
  dense_rows<T>(Y, c, 0, NT, c, a.fc1_w, hid, a.fc1_b, hid, 1, H1, hid);
  __syncthreads();
  gelu_rows<T>(H1, NT * hid);
  __syncthreads();
  if (d.stab_ccf)
    layer_norm_rows<T>(H1, hid, H1, hid, NT, hid, a.dwn_s, a.dwn_b, stats);
  for (int e = threadIdx.x; e < NT * hid; e += blockDim.x) {
    const int n = e / hid, ch = e - n * hid;
    const int gi = n / 4, gj = n % 4;          // 4x4 token grid
    const float* k = a.dw_w + ch * 9;
    float acc = 0.f;
    for (int ki = 0; ki < 3; ++ki) {
      for (int kj = 0; kj < 3; ++kj) {
        const int si = gi + ki - 1, sj = gj + kj - 1;
        const float v =
            (si >= 0 && si < 4 && sj >= 0 && sj < 4) ? H1[(si * 4 + sj) * hid + ch]
                                                     : 0.f;
        acc = fmaf(v, k[ki * 3 + kj], acc);
      }
    }
    float y = rnd<T>(acc);
    if (d.dw_bias) y = rnd<T>(y + rnd<T>(a.dw_b[ch]));
    if (d.stab_dw) y = rnd<T>(y * rnd<T>(a.dw_scale[ch]));
    H2[e] = y;
  }
  __syncthreads();
  if (d.stab_ccf)
    layer_norm_rows<T>(H2, hid, H2, hid, NT, hid, a.pdn_s, a.pdn_b, stats);
  dense_rows<T>(H2, hid, 0, NT, hid, a.fc2_w, c, a.fc2_b, c, 1, Z, c);
  __syncthreads();
  T* y_out = static_cast<T*>(a.y) + off;
  const float gamma = d.stab_ccf ? a.gamma[0] : 1.f;
  for (int e = threadIdx.x; e < NT * c; e += blockDim.x) {
    const float f = d.stab_ccf ? rnd<T>(Z[e] * gamma) : Z[e];
    y_out[e] = from_f<T>(R[e] + f);
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS) cross_tail_kernel(CrossTailArgs a) {
  QV_SMEM_DECL
  __shared__ int bad;
  cross_tail_sample<T>(a, blockIdx.x, false, qv_smem, &bad);
  if (a.d.guard)
    finish_guard(a.ws, bad, [&](int b) {
      cross_tail_sample<T>(a, b, true, qv_smem, &bad);
    });
}

}  // namespace qv

extern "C" int qv_unit_cross_tail(const qv::CrossTailArgs* a, int is_bf16,
                                  void* stream) {
  const size_t smem = qv::cross_tail_smem_floats(a->d) * sizeof(float);
  return is_bf16
             ? qv_launch(qv::cross_tail_kernel<qv::bf16>, *a, smem, stream)
             : qv_launch(qv::cross_tail_kernel<float>, *a, smem, stream);
}

extern "C" int qv_unit_cross_tail_smem(const qv::Dims* d) {
  return qv::cross_tail_smem_floats(*d) * (int)sizeof(float);
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
  }
  return -1;
}
