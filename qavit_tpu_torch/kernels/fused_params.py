"""The fused block's parameter layout
(counterpart of ``qavit_tpu/kernels/fused_params.py``).

:class:`QuadBlockParams` declares the QuadAttentionBlock's parameters at
the paths and shapes ``declare_block_params`` creates in the JAX tree, so
``param_tree(block)`` is the dictionary the unit functions and the CUDA
wrappers read (Dense kernels ``[in, out]``; the CCF-FFN depthwise kernel
as an OIHW ``[hidden, 1, 3, 3]`` Conv2d weight).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn as nn

from qavit_tpu_torch.configs.model import ModelConfig
from qavit_tpu_torch.kernels.fused_ref import FusedGeom
from qavit_tpu_torch.nn.layers import (CCFFFN, DENSE_STD, BottleneckMLP,
                                       Dense, HybridFusion, LayerNorm,
                                       Linformer, normal_)


class BlockDims(NamedTuple):
    """The widths the parameter holders and ``fused_ref.tail_ref`` read
    (fields named as in :class:`FusedGeom`), for any token grid: the
    branch path pads SWA windows where the grid does not tile them,
    which ``make_geom`` refuses."""

    n: int
    ws2: int
    lin_k: int
    groups: int
    cperg: int
    bottleneck_hidden: int
    ccf_hidden: int
    d_c: int
    dropout: float
    stabilized_ccfffn: bool
    stabilized_dwconv: bool
    dwconv_bias: bool


def block_dims(cfg: ModelConfig) -> BlockDims:
    """The widths of a flat block over ``cfg.num_patches`` tokens."""
    c = cfg.embed_dim
    return BlockDims(
        n=cfg.num_patches, ws2=cfg.window_size ** 2,
        lin_k=cfg.linformer_k, groups=cfg.num_channel_groups,
        cperg=c // 2 // cfg.num_channel_groups,
        bottleneck_hidden=c // cfg.bottleneck_ratio,
        ccf_hidden=int(c * cfg.mlp_ratio), d_c=c // cfg.compress_ratio,
        dropout=cfg.dropout, stabilized_ccfffn=cfg.stabilized_ccfffn,
        stabilized_dwconv=cfg.stabilized_dwconv,
        dwconv_bias=cfg.dwconv_bias)


class SWAParams(nn.Module):
    def __init__(self, c: int, g: FusedGeom):
        super().__init__()
        self.qkv = Dense(c, 3 * c)
        self.linformer = Linformer(g.ws2, g.lin_k)
        self.proj = Dense(c, c)
        self.norm = LayerNorm(c)


class MSDAParams(nn.Module):
    def __init__(self, cfg: ModelConfig, g: FusedGeom):
        super().__init__()
        c = cfg.embed_dim
        self.qkv_kernel = nn.Parameter(torch.empty(c, 3 * c))
        self.qkv_bias = nn.Parameter(torch.zeros(3 * c))
        self.linformer = Linformer(cfg.msda_pad_len, g.lin_k)
        self.proj = Dense(c, c)
        self.norm = LayerNorm(c)

    def reset_parameters(self, gen: torch.Generator) -> None:
        normal_(self.qkv_kernel, DENSE_STD, gen)


class CGAParams(nn.Module):
    def __init__(self, c: int, g: FusedGeom):
        super().__init__()
        cpg = c // g.groups
        self.q_proj = Dense(cpg, g.cperg)
        self.k_proj = Dense(cpg, g.cperg)
        self.v_proj = Dense(cpg, g.cperg)
        self.bank_k_proj = Dense(c, g.cperg)
        self.bank_v_proj = Dense(c, g.cperg)
        self.proj = Dense(c // 2, c)
        self.norm = LayerNorm(c)


class CrossParams(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.q_proj = Dense(c, c)
        self.k_proj = Dense(c, c)
        self.v_proj = Dense(c, c)
        self.proj = Dense(c, c)


class QuadBlockParams(nn.Module):
    """Every parameter of one QuadAttentionBlock (``declare_block_params``,
    ``fused_params.py:212-237``)."""

    def __init__(self, cfg: ModelConfig, g: FusedGeom):
        super().__init__()
        c = cfg.embed_dim
        self.norm1 = LayerNorm(c)
        self.swa, self.msda, self.cga, self.cross_attn = self.branches(cfg,
                                                                       g)
        self.fusion = HybridFusion(4)
        self.bottleneck_mlp = BottleneckMLP(c, g.bottleneck_hidden)
        self.norm2 = LayerNorm(c)
        self.ccf_ffn = CCFFFN(c, g.ccf_hidden, g.stabilized_ccfffn,
                              g.stabilized_dwconv, g.dwconv_bias)
        for name in ("swa", "msda", "cga", "cross"):
            self.add_module(f"norm_{name}", LayerNorm(c))
            self.add_module(f"compress_{name}", Dense(c, g.d_c))

    def branches(self, cfg: ModelConfig, g: FusedGeom):
        """The four branches' modules: parameter holders here; the branch
        path's block returns modules that also compute."""
        c = cfg.embed_dim
        return SWAParams(c, g), MSDAParams(cfg, g), CGAParams(c, g), \
            CrossParams(c)
