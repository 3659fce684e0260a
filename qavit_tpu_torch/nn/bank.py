"""Global token bank: parameters and the eval-time carry
(counterpart of ``qavit_tpu/nn/bank.py:41-92``).

The bank's K/V are parameters; the live value is a :class:`BankState`
threaded through the blocks.  In eval nothing writes to it, so every
block reads the parameter values; ``bank_write`` comes with the training
slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn as nn

from qavit_tpu_torch.configs.model import BankConfig
from qavit_tpu_torch.nn.layers import DENSE_STD, normal_


class BankState(NamedTuple):
    """Forward-pass carry of the global token bank."""

    k: torch.Tensor       # [1, S, C] float32
    v: torch.Tensor       # [1, S, C] float32
    count: torch.Tensor   # int32 scalar, persistent write counter


class GlobalBankParams(nn.Module):
    """Bank K/V and the (training-only) write projections, under the JAX
    tree's ``global_bank`` names."""

    def __init__(self, cfg: BankConfig, embed_dim: int):
        super().__init__()
        s, c = cfg.size, embed_dim
        self.cfg = cfg
        self.global_k = nn.Parameter(torch.empty(1, s, c))
        self.global_v = nn.Parameter(torch.empty(1, s, c))
        self.write_norm_scale = nn.Parameter(torch.ones(c))
        self.write_norm_bias = nn.Parameter(torch.zeros(c))
        self.write_compression_kernel = nn.Parameter(torch.empty(c, c))
        self.write_compression_bias = nn.Parameter(torch.zeros(c))
        self.write_gate_kernel = nn.Parameter(torch.empty(c, s))
        self.write_gate_bias = nn.Parameter(torch.zeros(s))

    def reset_parameters(self, gen: torch.Generator) -> None:
        for t in (self.global_k, self.global_v,
                  self.write_compression_kernel, self.write_gate_kernel):
            normal_(t, DENSE_STD, gen)


def bank_init_state(bank: GlobalBankParams, count: int) -> BankState:
    return BankState(bank.global_k.float(), bank.global_v.float(),
                     torch.tensor(count, dtype=torch.int32,
                                  device=bank.global_k.device))
