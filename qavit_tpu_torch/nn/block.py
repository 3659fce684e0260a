"""Quad-Attention blocks and the token compression around them
(counterpart of ``qavit_tpu/nn/block.py``).

The port always takes the fused dispatch of the JAX package's
``attn_impl="fused_block"`` (``nn/block.py:53-75``): the block's four
units run through :func:`qavit_tpu_torch.kernels.fused_block.
fused_quad_block`, as CUDA kernels on the card and as their plain
versions on the CPU (which equal the flax reference path in eval).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn as nn

from qavit_tpu_torch.configs.model import ModelConfig
from qavit_tpu_torch.kernels.fused_block import fused_quad_block
from qavit_tpu_torch.kernels.fused_params import QuadBlockParams
from qavit_tpu_torch.kernels.fused_ref import make_geom
from qavit_tpu_torch.nn.bank import BankState
from qavit_tpu_torch.nn.layers import Dense, LayerNorm, param_tree

Carry = Tuple[torch.Tensor, BankState]


class QuadAttentionBlock(QuadBlockParams):
    """pre-norm -> SWA -> MSDA -> CGA -> cross (bank carry) -> fusion tail
    -> CCF-FFN, as four fused units."""

    def __init__(self, cfg: ModelConfig, drop_path: float = 0.0):
        geom = make_geom(cfg)
        if geom is None:
            raise NotImplementedError(
                f"{cfg.name}: the fused block needs a square token grid that "
                f"tiles into SWA windows")
        super().__init__(cfg, geom)
        self.geom = geom
        # stochastic-depth rate of this block: the identity in eval; in
        # training it is a mask inside the tail unit, as in the JAX
        # fused path (fused_ref.tail_ref's dp1 / dp2)
        self.drop_path = drop_path

    def forward(self, carry: Carry, dtype) -> Carry:
        x, state = carry
        if self.training:
            raise NotImplementedError("the port serves the eval forward; "
                                      "training comes with the next slice")
        if x.shape[1] != self.geom.n:
            raise ValueError(f"block expects {self.geom.n} tokens, got "
                             f"{x.shape[1]}")
        return fused_quad_block(param_tree(self), x, state, self.geom, dtype)


class TokenLearner(nn.Module):
    """N tokens -> M by softmax-over-N weighted aggregation."""

    def __init__(self, embed_dim: int, num_out_tokens: int):
        super().__init__()
        self.attn_norm = LayerNorm(embed_dim)
        self.attn_fc = Dense(embed_dim, num_out_tokens)

    def forward(self, x: torch.Tensor, dtype) -> torch.Tensor:
        scores = self.attn_fc(self.attn_norm(x, dtype), dtype)
        w = torch.softmax(scores.float(), dim=1)
        return torch.einsum("bnm,bnc->bmc", w.to(x.dtype).float(),
                            x.float()).to(x.dtype)


class TokenUpMix(nn.Module):
    """M tokens -> N by a learned map over the token axis, then LN."""

    def __init__(self, embed_dim: int, num_in_tokens: int,
                 num_out_tokens: int):
        super().__init__()
        self.upsample_attn = Dense(num_in_tokens, num_out_tokens)
        self.norm = LayerNorm(embed_dim)

    def forward(self, x: torch.Tensor, dtype) -> torch.Tensor:
        y = self.upsample_attn(x.transpose(1, 2), dtype).transpose(1, 2)
        return self.norm(y, dtype)


def learned_tokens(cfg: ModelConfig) -> int:
    """M snapped down to a perfect square (``nn/block.py:176-179``)."""
    m = cfg.num_learned_tokens
    sq = math.isqrt(m)
    return m if sq * sq == m else max(4, sq * sq)


class QuadBlockWithTokenLearner(nn.Module):
    """TokenLearner(N -> M) -> QuadAttentionBlock -> TokenUpMix(M -> N)."""

    def __init__(self, cfg: ModelConfig, drop_path: float = 0.0):
        super().__init__()
        self.use_token_learner = cfg.use_token_learner
        if cfg.use_token_learner:
            m = learned_tokens(cfg)
            self.token_learner = TokenLearner(cfg.embed_dim, m)
            self.token_upmix = TokenUpMix(cfg.embed_dim, m, cfg.num_patches)
        self.quad_block = QuadAttentionBlock(cfg, drop_path)

    def forward(self, carry: Carry, dtype) -> Carry:
        if not self.use_token_learner:
            return self.quad_block(carry, dtype)
        x, state = carry
        xc, state = self.quad_block((self.token_learner(x, dtype), state),
                                    dtype)
        return self.token_upmix(xc, dtype), state
