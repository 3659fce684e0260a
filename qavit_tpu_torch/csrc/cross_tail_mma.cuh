// The bf16 tensor-core cross/tail unit's arguments and the geometry its
// kernels are written for: cross_tail_mma_kernel (unit_cross_tail.cu,
// n = 64 eval and n = 16) and cross_tail_train64_kernel
// (unit_cross_tail_train64.cu, n = 64 in training).
#pragma once
#include "mma_ops.cuh"

namespace qv {

struct CrossTailMmaArgs {
  CrossTailArgs f;        // the unit's arguments (its dense kernels unread)
  // the dense kernels rounded to bf16, side by side: [C, CT_W1] holds cq,
  // ck, cv, cp, compress_0..3, bottleneck fc1, CCF-FFN fc1 (C input rows
  // each); [CT_HID, CT_W2] bottleneck fc2, CCF-FFN fc2
  const bf16* w1;
  const bf16* w2;
};

// the geometry the kernels are written for
// (fused_kernels.cross_tail_mma_error)
constexpr int CT_N = 64;                // rows of a tile
constexpr int CT_C = 192, CT_H = 4;
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

}  // namespace qv
