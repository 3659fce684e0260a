"""HQAViT, the hybrid staged QA-ViT (counterpart of
``qavit_tpu/nn/models.py:122-187``), and the model factory.

The JAX package stacks each stage's blocks with ``nn.scan``; here a stage
is an ``nn.ModuleList`` named ``stage{i}_blocks`` and the bridge unstacks
the scan axis.  Images are NHWC, normalised float; the forward returns
float32 logits and the (eval-unchanged) bank state.  The flat ``QAViT``
waits for a later slice.
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
from qavit_tpu_torch.nn.block import QuadBlockWithTokenLearner
from qavit_tpu_torch.nn.hybrid import RRCV, CNNStemV1, LMFAdapter, SplitFusion
from qavit_tpu_torch.nn.layers import (DENSE_STD, Dense, LayerNorm, PatchEmbed,
                                       init_weights, normal_)


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def drop_path_rates(cfg: ModelConfig) -> np.ndarray:
    return np.linspace(0.0, cfg.drop_path, cfg.depth, dtype=np.float32)


class HQAViT(nn.Module):
    """CNN lateral stem + LMFA/RRCV laterals fused by SplitFusion before
    stages 2-4 of TokenLearner quad blocks."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.stem_kind != "v1":
            raise NotImplementedError(f"stem {cfg.stem_kind!r} is not ported "
                                      f"yet (v1 only)")
        self.cfg = cfg
        c, hw = cfg.embed_dim, cfg.grid_size
        self.global_bank = GlobalBankParams(cfg.bank, c)
        self.cnn_stem = CNNStemV1(cfg.cnn_c2, cfg.cnn_c3, cfg.cnn_c4,
                                  cfg.in_channels)
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
                self.add_module(f"fuse{stage_idx}", SplitFusion(c))
            self.add_module(f"stage{stage_idx}_blocks", nn.ModuleList(
                QuadBlockWithTokenLearner(cfg, float(dpr[idx + i]))
                for i in range(nblocks)))
            self.stages.append(stage_idx)
            idx += nblocks
        self.norm = LayerNorm(c)
        self.head = Dense(c, cfg.num_classes)

    def reset_parameters(self, gen: torch.Generator) -> None:
        normal_(self.pos_embed, DENSE_STD, gen)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, BankState]:
        cfg = self.cfg
        dtype = compute_dtype(cfg)
        hw = cfg.grid_size
        x = x.to(dtype)
        laterals = {}
        feats = self.cnn_stem(x, dtype)
        for i, f in zip((2, 3, 4), feats):
            a = getattr(self, f"lmfa{i}")(f, dtype)
            laterals[i] = getattr(self, f"rrcv{i}")(a, (hw, hw), dtype)

        t = self.patch_embed(x, dtype) + self.pos_embed.to(dtype)
        state = bank_init_state(self.global_bank, 0)
        for stage_idx in self.stages:
            if 2 <= stage_idx <= 4:
                t = getattr(self, f"fuse{stage_idx}")(
                    t, laterals[stage_idx], dtype)
            for block in getattr(self, f"stage{stage_idx}_blocks"):
                t, state = block((t, state), dtype)

        pooled = self.norm(t, dtype).float().mean(dim=1).to(dtype)
        return self.head(pooled, dtype).float(), state


def build_model(cfg: ModelConfig, device="cuda",
                generator: Optional[torch.Generator] = None,
                seed: int = 0) -> HQAViT:
    """An eval-mode HQAViT on ``device`` with weights drawn from
    ``generator`` (a CPU generator seeded with ``seed`` by default), so a
    seed gives the same weights on every device."""
    if not cfg.hybrid:
        raise NotImplementedError("the flat QAViT is not ported yet")
    gen = generator or torch.Generator().manual_seed(seed)
    model = init_weights(HQAViT(cfg), gen)
    return model.to(resolve_device(device)).eval()
