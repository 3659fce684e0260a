"""Fused QuadAttentionBlock, eval forward
(counterpart of ``qavit_tpu/kernels/fused_block.py``).

The block runs as four units in the reference order SWA -> MSDA -> CGA
-> cross + tail (``fused_kernels.py:209-242``).  In eval nothing writes
to the bank, so every unit reads the same bank rows and the state passes
through unchanged; ``finish_bank_update`` between the units comes with
the training slice.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from qavit_tpu_torch.kernels import fused_kernels as K
from qavit_tpu_torch.kernels.fused_ref import FusedGeom
from qavit_tpu_torch.nn.bank import BankState


def fused_quad_block(p: Dict[str, Any], x: torch.Tensor, state: BankState,
                     geom: FusedGeom, dtype) -> Tuple[torch.Tensor, BankState]:
    """One QuadAttentionBlock on tokens ``x`` [B, n, C] in ``dtype``."""
    x = x.to(dtype).contiguous()
    out_swa, xn = K.unit_swa(p, x, state.k, state.v, geom, dtype)
    out_msda = K.unit_msda(p, xn, state.k, state.v, geom, dtype)
    out_cga = K.unit_cga(p, xn, state.k, state.v, geom, dtype)
    y = K.unit_cross_tail(p, x, xn, out_swa, out_msda, out_cga, state.k,
                          state.v, geom, dtype)
    return y, state
