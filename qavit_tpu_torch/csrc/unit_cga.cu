// Unit 3 of the fused block, forward (eval and train): the CGA branch.
//
// Replaces the TPU unit qavit_tpu/kernels/fused_kernels.py
// make_cores.core_cga (fused_cores.py:708 cga_bd, _cga_sweep :295), run
// through fused_pallas.py:190-212 fwd_call.
//
// Per sample: 6 channel groups of 32; q/k/v = Dense 32 -> 16 per group
// (weights shared by the groups); the bank K/V projected 192 -> 16 and
// shared by the groups (kv = 16 + 16 = 32); 24 virtual heads
// (6 groups x 4 heads) of width 4, float32 softmax; proj 96 -> 192.  The
// bank projections are the kernel's own work, as in the TPU body; each
// block computes them once and keeps them for all its samples.  In
// training: the hash masks and the bank-write partials, as in unit 1.
//
// Bound on the H100 at B=1024 (bf16): 6.3 MB read + 6.3 MB written
// (~3.8 us) against ~0.9 GFLOP (~1 us): the bytes bound it.
//
// float32 (and bf16 at widths cga_mma_kernel does not take): cga_kernel,
// the first design on the CUDA cores.  A 256-thread block keeps the [24,
// 16, 32] float32 scores and every projection in ~100 KB of shared memory
// (two blocks share an SM; 12 KB more in training); latency-bound.
//
// n = 64 (hqavit_tiny_in, eval), float32: the scores of all 24 virtual
// heads would take 480 KB, so cga_tiled_kernel projects q/k/v (all
// groups, 24 KB per tensor) in 16-token tiles, then runs the attention one
// channel group (4 heads x 64 queries x 80 keys, 80 KB of scores) at a
// time, and the proj in 16-token tiles: 195 KB of shared memory at C=192,
// one block per SM.  Every element is summed in the order of the n = 16
// kernel.
//
// bf16 at C=192 in 6 groups of 32 (hqavit_c100, n = 16, eval and
// training; hqavit_tiny_in, n = 64, eval): cga_mma_kernel, every product
// on the tensor cores (mma.sync m16n8k16, bf16 operands, float32 sums),
// the scores in registers, one block per SM walking tiles of 64 rows
// (four samples of 16, or one of 64); its body and layout are
// cga_mma.cuh's.  Time: PERF.md section 6 rows 3, 3 @n64 and 3 @n64
// train.
#include "common.cuh"

QV_STAMPS_DEFINE(cga_fwd,
                 "weights and bank projection,x staging,q|k|v,attention,"
                 "proj,tile partials,partials store,guard")
#define CGA_FWD_STAMP(k) QV_STAMP(cga_fwd, k)

#include "cga_mma.cuh"
#include "unit_cga.cuh"

namespace qv {

__host__ __device__ inline int cga_smem_floats(const Dims& d) {
  const int c = d.c, gw = d.groups * d.cperg, s = d.bank_s;
  return NT * c                 // xs, then the proj output
         + 3 * NT * gw          // q, k, v of all groups, then LN(out)
         + s * c                // bank rows k, then v
         + 2 * s * d.cperg      // projected bank k, v
         + NT * gw              // attention output
         + (d.train ? NT * c : 0)  // the partials' compressed rows
         + pad4(d.groups * d.heads * NT * (NT + s))
         + 2 * NT;              // LN stats
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS, 2) cga_kernel(CgaArgs a) {
  QV_SMEM_DECL
  __shared__ int bad;
  const Dims& d = a.d;
  const int c = d.c, S = d.bank_s, cperg = d.cperg;
  const int gw = d.groups * cperg;
  float* xs = qv_smem;
  float* q = xs + NT * c;
  float* k = q + NT * gw;
  float* v = k + NT * gw;
  float* braw = v + NT * gw;
  float* kbp = braw + S * c;
  float* vbp = kbp + S * cperg;
  float* att = vbp + S * cperg;
  float* comp = att + NT * gw;
  float* sc = comp + (d.train ? NT * c : 0);
  float* stats = sc + pad4(d.groups * d.heads * NT * (NT + S));
  const CgaBufs s{xs, q, k, v, kbp, vbp, att, xs, sc, sc};
  float* part = d.train ? a.bw.part + (size_t)blockIdx.x * 2 * S * c : nullptr;

  if (threadIdx.x == 0) bad = 0;
  if (part != nullptr) fill(part, 2 * S * c, 0.f);
  cga_prologue<T>(a, nullptr, nullptr, braw, s);
  auto sample = [&](int b, bool zero_attn, float* acc) {
    cga_body<T>(a, b, zero_attn, s, &bad);
    store_tile<T>(static_cast<T*>(a.out) + (size_t)b * NT * c, xs, NT * c);
    __syncthreads();
    if (acc != nullptr)
      bank_partials<T>(xs, a.bw, c, S, q, comp, sc, stats, acc);
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

__host__ __device__ inline int cga_tiled_smem_floats(const Dims& d) {
  const int c = d.c, gw = d.groups * d.cperg, s = d.bank_s, n = d.n;
  const int sc = pad4(d.heads * n * (n + s));
  return NT * c                 // an xn tile, then a proj output tile
         + 3 * n * gw           // q, k, v of all groups
         + 2 * s * d.cperg      // projected bank k, v
         + n * gw               // attention output
         + (sc > s * c ? sc : s * c);  // one group's scores; bank rows
}

// Eval only, n a multiple of NT; one block per sample.
template <typename T>
__global__ void __launch_bounds__(NTHREADS, 1) cga_tiled_kernel(CgaArgs a) {
  QV_SMEM_DECL
  __shared__ int bad;
  const Dims& d = a.d;
  const int c = d.c, S = d.bank_s, cperg = d.cperg, gg = d.groups;
  const int n = d.n, gw = gg * cperg, cpg = c / gg;
  float* xt = qv_smem;
  float* q = xt + NT * c;
  float* k = q + n * gw;
  float* v = k + n * gw;
  float* kbp = v + n * gw;
  float* vbp = kbp + S * cperg;
  float* att = vbp + S * cperg;
  float* sc = att + n * gw;       // the bank rows during the prologue
  CgaBufs s{};
  s.kbp = kbp;
  s.vbp = vbp;

  if (threadIdx.x == 0) bad = 0;
  cga_prologue<T>(a, nullptr, nullptr, sc, s);
  auto sample = [&](int b, bool zero_attn) {
    const T* in = static_cast<const T*>(a.xn) + (size_t)b * n * c;
    T* out = static_cast<T*>(a.out) + (size_t)b * n * c;
    for (int t0 = 0; t0 < n; t0 += NT) {
      load_tile<T>(xt, in + (size_t)t0 * c, NT * c);
      __syncthreads();
      const int r = t0 * gw;
      dense_rows<T>(xt, c, cpg, NT, cpg, a.q_w, cperg, a.q_b, cperg, gg,
                    q + r, gw);
      dense_rows<T>(xt, c, cpg, NT, cpg, a.k_w, cperg, a.k_b, cperg, gg,
                    k + r, gw);
      dense_rows<T>(xt, c, cpg, NT, cpg, a.v_w, cperg, a.v_b, cperg, gg,
                    v + r, gw);
      __syncthreads();
    }
    if (zero_attn) {
      fill(att, n * gw, 0.f);
      __syncthreads();
    } else {
      for (int g = 0; g < gg; ++g)    // group g's heads, bank heads shared
        attention<T>(q + g * cperg, gw, n, d.heads, cperg / d.heads,
                     k + g * cperg, v + g * cperg, gw, n, kbp, vbp, cperg, S,
                     d.heads, att + g * cperg, gw, sc, sc, no_drop(), 0u,
                     &bad, d.guard != 0);
    }
    for (int t0 = 0; t0 < n; t0 += NT) {
      dense_rows<T>(att + t0 * gw, gw, 0, NT, gw, a.proj_w, c, a.proj_b, c, 1,
                    xt, c);
      __syncthreads();
      store_tile<T>(out + (size_t)t0 * c, xt, NT * c);
      __syncthreads();
    }
  };
  for (int b = blockIdx.x; b < d.B; b += gridDim.x) sample(b, false);
  if (d.guard)
    finish_guard(a.ws, bad, [&] {
      for (int b = 0; b < d.B; ++b) sample(b, true);
    });
}

// --- bf16: the tensor-core kernel (cga_mma.cuh) ---------------------------

// NS samples a tile: 1 at n = 64, 4 at n = 16; TRAIN the training
// instances
template <int NS, bool TRAIN>
__global__ void __launch_bounds__(NTHREADS, 1) cga_mma_kernel(CgaMmaArgs m) {
  cga_mma<NS, TRAIN>(m);
}

}  // namespace qv

extern "C" int qv_unit_cga_smem(const qv::Dims* d);

extern "C" int qv_unit_cga(const qv::CgaArgs* a, int is_bf16, void* stream) {
  const size_t smem = qv_unit_cga_smem(&a->d);
  if (a->d.n != qv::NT) {         // eval only; bf16 is qv_unit_cga_mma's
    if (a->d.train || is_bf16) return qv::ERR_ARGS;
    return qv_launch(qv::cga_tiled_kernel<float>, *a, smem, stream,
                     a->d.grid);
  }
  const int rc =
      is_bf16 ? qv_launch(qv::cga_kernel<qv::bf16>, *a, smem, stream,
                          a->d.grid)
              : qv_launch(qv::cga_kernel<float>, *a, smem, stream, a->d.grid);
  if (rc != 0 || !a->d.train) return rc;
  return qv_reduce(a->bw.part, a->bw.part_out, a->d.grid,
                   2 * a->d.bank_s * a->d.c, a->d.rgrid, stream);
}

extern "C" int qv_unit_cga_smem(const qv::Dims* d) {
  return (d->n == qv::NT ? qv::cga_smem_floats(*d)
                         : qv::cga_tiled_smem_floats(*d)) *
         (int)sizeof(float);
}

// The bf16 tensor-core kernel: `a` as for qv_unit_cga, the packed q | k |
// v kernel [32, 48] and the proj kernel [96, 192] rounded to bf16 beside
// it; one block per tile of 64 rows at most.  n = 16 in one window in
// eval and training (then the reduction pass of the bank partials
// follows), or n = 64 in four windows on an 8x8 grid in eval; ERR_ARGS for
// any other geometry or type (the wrapper checks them first,
// cga_mma_error).
extern "C" int qv_unit_cga_mma(const qv::CgaArgs* a, const void* qkv_w16,
                               const void* proj_w16, int is_bf16,
                               void* stream) {
  const qv::Dims& d = a->d;
  const bool n64 = d.n == qv::CG_ROWS && d.nw == 4 && d.side == 8 && !d.train;
  const bool n16 = d.n == qv::NT && d.nw == 1 && d.side == qv::WS;
  const int tiles = (d.B * d.n + qv::CG_ROWS - 1) / qv::CG_ROWS;
  if (!is_bf16 || !(n64 || n16) || d.c != qv::CG_C || d.groups != qv::CG_G ||
      d.cperg != qv::CG_CPERG || d.heads != qv::CG_H ||
      d.bank_s > qv::CG_S || d.grid > tiles)
    return qv::ERR_ARGS;
  const qv::CgaMmaArgs m{*a, static_cast<const qv::bf16*>(qkv_w16),
                         static_cast<const qv::bf16*>(proj_w16)};
  const size_t smem = d.train ? qv::CG_TRAIN_BYTES : qv::CG_EVAL_BYTES;
  const int rc =
      n64 ? qv_launch(qv::cga_mma_kernel<1, false>, m, smem, stream, d.grid)
      : d.train
          ? qv_launch(qv::cga_mma_kernel<4, true>, m, smem, stream, d.grid)
          : qv_launch(qv::cga_mma_kernel<4, false>, m, smem, stream, d.grid);
  if (rc != 0 || !d.train) return rc;
  return qv_reduce(a->bw.part, a->bw.part_out, d.grid, 2 * d.bank_s * d.c,
                   d.rgrid, stream);
}

extern "C" int qv_unit_cga_mma_smem(const qv::Dims* d) {
  return d->train ? qv::CG_TRAIN_BYTES : qv::CG_EVAL_BYTES;
}

// The bf16 tensor-core kernel in training at n = 64 (cga_mma_kernel<1,
// true>, a tile a sample), then the reduction pass of the bank partials
// and the compression of their sum (qv_bank_compress: the blocks store
// part_v and the gate sums, bank_store_sums): `a` and the weights as for
// qv_unit_cga_mma; ERR_ARGS for any other geometry or type (the wrapper
// checks them first, cga_mma_error).
extern "C" int qv_unit_cga_mma_train64(const qv::CgaArgs* a,
                                       const void* qkv_w16,
                                       const void* proj_w16, int is_bf16,
                                       void* stream) {
  const qv::Dims& d = a->d;
  if (!is_bf16 || !d.train || d.n != qv::CG_ROWS || d.nw != 4 ||
      d.side != 8 || d.c != qv::CG_C || d.groups != qv::CG_G ||
      d.cperg != qv::CG_CPERG || d.heads != qv::CG_H ||
      d.bank_s > qv::CG_S || d.grid > d.B)
    return qv::ERR_ARGS;
  const qv::CgaMmaArgs m{*a, static_cast<const qv::bf16*>(qkv_w16),
                         static_cast<const qv::bf16*>(proj_w16)};
  int rc = qv_launch(qv::cga_mma_kernel<1, true>, m, qv::CG_TRAIN_BYTES,
                     stream, d.grid);
  if (rc == 0)
    rc = qv_reduce(a->bw.part, a->bw.part_out, d.grid, 2 * d.bank_s * d.c,
                   d.rgrid, stream);
  if (rc != 0) return rc;
  return qv_bank_compress(a->bw.part_out, a->bw.comp_w, a->bw.comp_b,
                          d.bank_s, stream);
}

extern "C" int qv_unit_cga_mma_train64_smem(const qv::Dims*) {
  return qv::CG_TRAIN_BYTES;
}
