"""Quad-Attention blocks and the token compression around them
(counterpart of ``qavit_tpu/nn/block.py``).

Two forms of the QuadAttentionBlock, as in the JAX package:

* :class:`QuadAttentionBlock`, the fused dispatch of
  ``attn_impl="fused_block"`` (``nn/block.py:53-75``): four units run
  through :func:`qavit_tpu_torch.kernels.fused_block.fused_quad_block`,
  as CUDA kernels on the card and as their plain versions on the CPU
  (which equal the flax reference path).  In training (an ``rng`` given)
  each block draws its masks from its own seed and its drop-path rate,
  and writes the bank three times.
* :class:`BranchQuadBlock`, the flax branch path (``nn/block.py:77-119``):
  the four branch modules of ``nn/branches.py``, whose attentions go
  through the per-shape dispatch of ``kernels/attention.py``, then the
  block tail.  In training (an ``rng`` given) the branches drop out and
  write the bank (SWA, MSDA, CGA), and the tail draws its dropout and
  drop-path masks from ``rng``'s generator.

:func:`flat_block` chooses between them for the flat QAViT as
``nn/block.py:58-75`` does.  HQAViT's TokenLearner blocks always take the
fused form, whatever ``attn_impl`` says: the JAX package would take the
branch path there for ``attn_impl != "fused_block"``.  This is a known
divergence (ROADMAP queue 3); the JAX package holds its fused units to the
flax path's function (``tests/test_fused_block.py:128``).  The unit
kernels take the learned-token geometries of both HQAViT families, in
eval and in training: n=16 in one SWA window (``hqavit_c100``) and n=64
in four (``hqavit_tiny_in``; on the card it trains in bf16, float32
raising before the launch, ROADMAP queue 2 item 2d), and the flat
QAViT's n=64 (``qavit_v2_extreme_proc100``) and n=256 in sixteen windows
(``qavit_v2_extreme_tin``, bf16 only in eval and training); n=196 (the
224 presets) raises, naming queue 2 item 2c.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn

from qavit_tpu_torch.configs.model import ModelConfig
from qavit_tpu_torch.kernels import fused_ref as R
from qavit_tpu_torch.kernels.fused_block import fused_quad_block
from qavit_tpu_torch.kernels.fused_kernels import UnitTrain
from qavit_tpu_torch.kernels.fused_params import (BlockDims,
                                                  QuadBlockParams,
                                                  block_dims)
from qavit_tpu_torch.kernels.fused_ref import make_geom
from qavit_tpu_torch.nn import taps
from qavit_tpu_torch.nn.bank import BankState
from qavit_tpu_torch.nn.branches import (ChannelGroupAttention,
                                         CrossAttentionBranch,
                                         MultiScaleDilatedAttention,
                                         SpatialWindowAttention)
from qavit_tpu_torch.nn.layers import (Dense, DropoutRng, DropPath, LayerNorm,
                                       keep_mask, param_tree)

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
        self.bank_cfg = cfg.bank
        # stochastic-depth rate of this block: the identity in eval; in
        # training it is a mask inside the tail unit, as in the JAX
        # fused path (fused_ref.tail_ref's dp1 / dp2)
        self.drop_path = drop_path

    def forward(self, carry: Carry, dtype, rng: Optional[DropoutRng] = None,
                bank_write: Optional[dict] = None) -> Carry:
        """``rng`` (training) with ``bank_write``, the bank's write
        projections (``GlobalBankParams.write_params``)."""
        x, state = carry
        if x.shape[1] != self.geom.n:
            raise ValueError(f"block expects {self.geom.n} tokens, got "
                             f"{x.shape[1]}")
        train = None
        if rng is not None:
            train = UnitTrain(R.block_rng(rng.block_seed(), self.geom.dropout,
                                          self.drop_path), bank_write)
        return fused_quad_block(param_tree(self), x, state, self.geom, dtype,
                                train, self.bank_cfg)


class BranchQuadBlock(QuadBlockParams):
    """pre-norm -> SWA, MSDA, CGA, cross (each reading the bank, the
    first three writing it in training) -> per-branch LN + compress ->
    softmax fusion -> bottleneck MLP -> residual -> norm2 -> CCF-FFN ->
    residual.  The tail is ``fused_ref.tail_ref``, the flax tail's
    function; in training its masks are flax ``Dropout``'s (the bottleneck
    MLP's two, the CCF-FFN's) and ``DropPath``'s (``drop_path1``,
    ``drop_path2``) at the block's rate, drawn from ``rng``."""

    def __init__(self, cfg: ModelConfig, drop_path: float = 0.0):
        self.dims = block_dims(cfg)
        super().__init__(cfg, self.dims)
        self.drop_path = DropPath(drop_path)

    def branches(self, cfg: ModelConfig, dims: BlockDims):
        return (SpatialWindowAttention(cfg, dims),
                MultiScaleDilatedAttention(cfg, dims),
                ChannelGroupAttention(cfg, dims),
                CrossAttentionBranch(cfg, dims))

    def forward(self, carry: Carry, dtype, rng: Optional[DropoutRng] = None,
                bank_write: Optional[dict] = None) -> Carry:
        """``rng`` (training) with ``bank_write``, the bank's write
        projections (``GlobalBankParams.write_params``)."""
        x, state = carry
        x = x.to(dtype)
        p = param_tree(self)
        xn = R.layer_norm(x, p["norm1"], dtype)
        outs = []
        for branch in (self.swa, self.msda, self.cga, self.cross_attn):
            out, state = branch(xn, state, dtype, rng, bank_write)
            outs.append(out)
        return R.tail_ref(p, x, outs, self.dims, dtype,
                          self._tail_masks(x, dtype, rng)), state

    def _tail_masks(self, x: torch.Tensor, dtype, rng: Optional[DropoutRng]):
        """(bn1, bn2, dp1, ffn, dp2) of ``tail_ref``, drawn in that
        order; all None in eval."""
        if rng is None:
            return (None,) * 5
        b, n, c = x.shape
        d, dev = self.dims, x.device
        bn1 = keep_mask((b, n, d.bottleneck_hidden), d.dropout, rng, dev)
        bn2 = keep_mask((b, n, c), d.dropout, rng, dev)
        dp1 = self.drop_path.mask(b, dtype, rng, dev)
        ffn = keep_mask((b, n, c), d.dropout, rng, dev)
        return bn1, bn2, dp1, ffn, self.drop_path.mask(b, dtype, rng, dev)


def flat_block(cfg: ModelConfig, drop_path: float = 0.0) -> nn.Module:
    """The flat QAViT's block: the fused units when ``attn_impl`` is
    "fused_block" and ``make_geom`` covers the grid (n=64 and n=256 run
    on the kernels; n=196 raises at the first launch, naming its ROADMAP
    item), else the branch path (``nn/block.py:58-75``).  ``drop_path``
    is the block's stochastic
    depth rate, which both blocks read in training."""
    if cfg.attn_impl == "fused_block" and make_geom(cfg) is not None:
        return QuadAttentionBlock(cfg, drop_path)
    return BranchQuadBlock(cfg, drop_path)


class TokenLearner(nn.Module):
    """N tokens -> M by softmax-over-N weighted aggregation."""

    def __init__(self, embed_dim: int, num_out_tokens: int):
        super().__init__()
        self.attn_norm = LayerNorm(embed_dim)
        self.attn_fc = Dense(embed_dim, num_out_tokens)

    def forward(self, x: torch.Tensor, dtype) -> torch.Tensor:
        scores = self.attn_fc(self.attn_norm(x, dtype), dtype)
        w = torch.softmax(scores.float(), dim=1)
        taps.sow("token_learner.weights", w)     # attention rollout's map
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

    def forward(self, carry: Carry, dtype, rng: Optional[DropoutRng] = None,
                bank_write: Optional[dict] = None) -> Carry:
        if not self.use_token_learner:
            return self.quad_block(carry, dtype, rng, bank_write)
        x, state = carry
        xc, state = self.quad_block((self.token_learner(x, dtype), state),
                                    dtype, rng, bank_write)
        return self.token_upmix(xc, dtype), state
