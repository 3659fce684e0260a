"""QAViT, the flat QA-ViT, and HQAViT, the hybrid staged QA-ViT
(counterparts of ``qavit_tpu/nn/models.py:81-187``), and the model
factory.

The JAX package stacks blocks with ``nn.scan``; here a stack is an
``nn.ModuleList`` (``blocks``, ``stage{i}_blocks``) and the bridge
unstacks the scan axis.  Images are NHWC, normalised float; the forward
returns float32 logits and the bank state after the forward (unchanged
in eval; in training after three writes per block, for the train step to
copy into the parameters).  Both models train: ``train=True`` with
``rng``, the step's ``DropoutRng``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from qavit_tpu_torch.configs.model import ModelConfig
from qavit_tpu_torch.device import resolve_device
from qavit_tpu_torch.nn.bank import (BankState, GlobalBankParams,
                                     bank_init_state)
from qavit_tpu_torch.nn.block import QuadBlockWithTokenLearner, flat_block
from qavit_tpu_torch.nn.hybrid import (RRCV, CNNStemConvNeXt, CNNStemV1,
                                       LMFAdapter, SplitFusion)
from qavit_tpu_torch.nn.layers import (DENSE_STD, Dense, DropoutRng,
                                       LayerNorm, PatchEmbed, dropout,
                                       init_weights, normal_)


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def drop_path_rates(cfg: ModelConfig) -> np.ndarray:
    return np.linspace(0.0, cfg.drop_path, cfg.depth, dtype=np.float32)


class QAViT(nn.Module):
    """Flat Quad-Attention ViT (QAViT.py:654-699): patch embedding and
    position embedding, ``pos_drop``, ``depth`` quad blocks (``flat_block``:
    the fused units or the branch path), LN, mean-pool, head."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg.embed_dim
        self.global_bank = GlobalBankParams(cfg.bank, c)
        self.patch_embed = PatchEmbed(cfg.patch_size, cfg.in_channels, c)
        self.pos_embed = nn.Parameter(torch.empty(1, cfg.num_patches, c))
        dpr = drop_path_rates(cfg)
        self.blocks = nn.ModuleList(flat_block(cfg, float(dpr[i]))
                                    for i in range(cfg.depth))
        self.norm = LayerNorm(c)
        self.head = Dense(c, cfg.num_classes)

    def reset_parameters(self, gen: torch.Generator) -> None:
        normal_(self.pos_embed, DENSE_STD, gen)

    def forward(self, x: torch.Tensor, train: bool = False, bank_count=0,
                rng: Optional[DropoutRng] = None,
                return_features: bool = False
                ) -> Tuple[torch.Tensor, BankState]:
        """Logits (or, with ``return_features``, the pooled features) and
        the bank state.  ``train`` needs ``rng``, the step's dropout state
        (one draw of each block's masks from it, block after block);
        ``bank_count`` is the persistent bank write count."""
        if train and rng is None:
            raise ValueError("a train forward needs rng=DropoutRng(...)")
        rng = rng if train else None
        dtype = compute_dtype(self.cfg)
        t = self.patch_embed(x.to(dtype), dtype) + self.pos_embed.to(dtype)
        t = dropout(t, self.cfg.dropout, rng)
        state = bank_init_state(self.global_bank, bank_count)
        bank_write = self.global_bank.write_params() if train else None
        for block in self.blocks:
            t, state = block((t, state), dtype, rng, bank_write)
        pooled = self.norm(t, dtype).float().mean(dim=1).to(dtype)
        if return_features:
            return pooled.float(), state
        return self.head(pooled, dtype).float(), state


class HQAViT(nn.Module):
    """CNN lateral stem (``cfg.stem_kind``: "v1", the conv/BN stem, else
    the ConvNeXt-patchify stem) + LMFA/RRCV laterals fused by SplitFusion
    before stages 2-4 of TokenLearner quad blocks."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        c, hw = cfg.embed_dim, cfg.grid_size
        self.global_bank = GlobalBankParams(cfg.bank, c)
        if cfg.stem_kind == "v1":
            self.cnn_stem = CNNStemV1(cfg.cnn_c2, cfg.cnn_c3, cfg.cnn_c4,
                                      cfg.in_channels)
        else:
            self.cnn_stem = CNNStemConvNeXt(cfg.cnn_c2, cfg.cnn_c3,
                                            cfg.cnn_c4, cfg.in_channels,
                                            cfg.img_size)
        for i, cin in ((2, cfg.cnn_c2), (3, cfg.cnn_c3), (4, cfg.cnn_c4)):
            self.add_module(f"lmfa{i}", LMFAdapter(cin, c, hw))
            self.add_module(f"rrcv{i}", RRCV(c, cfg.rrcv_channels,
                                             cfg.rrcv_num_blocks))
        self.patch_embed = PatchEmbed(cfg.patch_size, cfg.in_channels, c)
        self.pos_embed = nn.Parameter(torch.empty(1, cfg.num_patches, c))
        dpr = drop_path_rates(cfg)
        idx = 0
        self.stages = []
        for stage_idx, nblocks in enumerate(cfg.stage_blocks, start=1):
            if nblocks == 0:          # zero-length stages hold no params
                continue
            if 2 <= stage_idx <= 4:
                self.add_module(f"fuse{stage_idx}",
                                SplitFusion(c, cfg.dropout))
            self.add_module(f"stage{stage_idx}_blocks", nn.ModuleList(
                QuadBlockWithTokenLearner(cfg, float(dpr[idx + i]))
                for i in range(nblocks)))
            self.stages.append(stage_idx)
            idx += nblocks
        self.norm = LayerNorm(c)
        self.head = Dense(c, cfg.num_classes)

    def reset_parameters(self, gen: torch.Generator) -> None:
        normal_(self.pos_embed, DENSE_STD, gen)

    def forward(self, x: torch.Tensor, train: bool = False, bank_count=0,
                rng: Optional[DropoutRng] = None,
                return_features: bool = False
                ) -> Tuple[torch.Tensor, BankState]:
        """Logits (or, with ``return_features``, the pooled features in
        float32, as SimCLR takes them) and the bank state.  ``train``
        needs ``rng``, the step's dropout state; ``bank_count`` is the
        persistent bank write count."""
        if train and rng is None:
            raise ValueError("a train forward needs rng=DropoutRng(...)")
        rng = rng if train else None
        cfg = self.cfg
        dtype = compute_dtype(cfg)
        hw = cfg.grid_size
        x = x.to(dtype)
        laterals = {}
        feats = self.cnn_stem(x, dtype, rng)
        for i, f in zip((2, 3, 4), feats):
            a = getattr(self, f"lmfa{i}")(f, dtype)
            laterals[i] = getattr(self, f"rrcv{i}")(a, (hw, hw), dtype, rng)

        t = self.patch_embed(x, dtype) + self.pos_embed.to(dtype)
        t = dropout(t, cfg.dropout, rng)
        state = bank_init_state(self.global_bank, bank_count)
        bank_write = self.global_bank.write_params() if train else None
        for stage_idx in self.stages:
            if 2 <= stage_idx <= 4:
                t = getattr(self, f"fuse{stage_idx}")(
                    t, laterals[stage_idx], dtype, rng)
            for block in getattr(self, f"stage{stage_idx}_blocks"):
                t, state = block((t, state), dtype, rng, bank_write)

        pooled = self.norm(t, dtype).float().mean(dim=1).to(dtype)
        if return_features:
            return pooled.float(), state
        return self.head(pooled, dtype).float(), state


def build_model(cfg: ModelConfig, device="cuda",
                generator: Optional[torch.Generator] = None,
                seed: int = 0) -> nn.Module:
    """An HQAViT (``cfg.hybrid``) or a QAViT on ``device`` (in eval mode)
    with weights drawn from ``generator`` (a CPU generator seeded with
    ``seed`` by default), so a seed gives the same weights on every
    device."""
    gen = generator or torch.Generator().manual_seed(seed)
    model = init_weights((HQAViT if cfg.hybrid else QAViT)(cfg), gen)
    return model.to(resolve_device(device)).eval()
