"""HQA-ViT hybrid CNN side path (counterpart of ``qavit_tpu/nn/hybrid.py``):
ConvNeXtBlock (:21), the v1 conv/BN stem CNNStemV1 (:49-92), LMFAdapter
(:157), RRCV (:187) and SplitFusion (:215).  Feature maps are NHWC, as
in the JAX package; each convolution runs as an OIHW ``nn.Conv2d``
through :func:`conv_nhwc`.  The ConvNeXt-patchify stem waits for a later
slice.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from qavit_tpu_torch.nn.dwconv import depthwise_conv2d
from qavit_tpu_torch.nn.layers import Dense, LayerNorm, conv_nhwc


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x.float()).to(x.dtype)


class ConvNeXtBlock(nn.Module):
    """dw7x7 -> LN(eps 1e-6) -> Dense 4x -> GELU -> Dense -> residual."""

    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = depthwise_conv2d(dim, 7)
        self.norm = LayerNorm(dim, eps=1e-6)
        self.pwconv1 = Dense(dim, 4 * dim)
        self.pwconv2 = Dense(4 * dim, dim)

    def forward(self, x: torch.Tensor, dtype) -> torch.Tensor:
        y = self.norm(conv_nhwc(self.dwconv, x, dtype), dtype)
        y = self.pwconv2(_gelu(self.pwconv1(y, dtype)), dtype)
        return x + y


class CNNStemV1(nn.Module):
    """v1 lateral CNN: conv/BN stem and 1x1-projected stages, 32x32 ->
    16x16 -> 8x8; returns F2/F3/F4 as NHWC maps.  BatchNorm runs on its
    running statistics (eval)."""

    def __init__(self, c2: int, c3: int, c4: int, in_channels: int = 3):
        super().__init__()

        def bn(c):
            return nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)

        self.stem_conv = nn.Conv2d(in_channels, 32, 3, stride=2, padding=1)
        self.stem_bn = bn(32)
        self.stage1_conv = nn.Conv2d(32, c2, 3, stride=2, padding=1)
        self.stage1_bn = bn(c2)
        self.stage1_block = ConvNeXtBlock(c2)
        self.stage2_conv = nn.Conv2d(c2, c3, 1)
        self.stage2_bn = bn(c3)
        self.stage2_block = ConvNeXtBlock(c3)
        self.stage3_conv = nn.Conv2d(c3, c4, 1)
        self.stage3_bn = bn(c4)
        self.stage3_block = ConvNeXtBlock(c4)

    @staticmethod
    def _bn(bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
        # NHWC: the channel axis is last; float32 statistics
        y = F.batch_norm(x.float().permute(0, 3, 1, 2), bn.running_mean,
                         bn.running_var, bn.weight, bn.bias, False, 0.0,
                         bn.eps)
        return y.permute(0, 2, 3, 1).to(x.dtype)

    def forward(self, x: torch.Tensor, dtype):
        y = _gelu(self._bn(self.stem_bn, conv_nhwc(self.stem_conv, x, dtype)))
        y = _gelu(self._bn(self.stage1_bn,
                           conv_nhwc(self.stage1_conv, y, dtype)))
        f2 = self.stage1_block(y, dtype)
        y = self._bn(self.stage2_bn, conv_nhwc(self.stage2_conv, f2, dtype))
        f3 = self.stage2_block(y, dtype)
        y = self._bn(self.stage3_bn, conv_nhwc(self.stage3_conv, f3, dtype))
        f4 = self.stage3_block(y, dtype)
        return f2, f3, f4


class LMFAdapter(nn.Module):
    """CNN map -> tokens: {dw3x3, dw5x5, identity} concat -> 1x1 proj ->
    LN -> GELU.  The v1 stem's maps already sit on the token grid, so the
    JAX package's bilinear resize never runs for the presets the port
    serves; another grid raises."""

    def __init__(self, in_channels: int, embed_dim: int, target_hw: int):
        super().__init__()
        self.target_hw = target_hw
        self.dwconv_3x3 = depthwise_conv2d(in_channels, 3)
        self.dwconv_5x5 = depthwise_conv2d(in_channels, 5)
        self.proj = nn.Conv2d(3 * in_channels, embed_dim, 1)
        self.norm = LayerNorm(embed_dim)

    def forward(self, feat: torch.Tensor, dtype) -> torch.Tensor:
        b, h, w, _ = feat.shape
        if h != self.target_hw or w != self.target_hw:
            raise NotImplementedError(
                f"LMFAdapter: a {h}x{w} map needs the resize to "
                f"{self.target_hw}x{self.target_hw}, not ported yet")
        f1 = conv_nhwc(self.dwconv_3x3, feat, dtype)
        f2 = conv_nhwc(self.dwconv_5x5, feat, dtype)
        f_cat = torch.cat([f1, f2, feat.to(dtype)], dim=-1)
        tokens = conv_nhwc(self.proj, f_cat, dtype).reshape(b, h * w, -1)
        return _gelu(self.norm(tokens, dtype))


class RRCV(nn.Module):
    """Tokens -> map -> 1x1 to rec_channels -> ConvNeXt block(s) -> 1x1
    back -> LN -> tokens + beta * R."""

    def __init__(self, embed_dim: int, rec_channels: int, num_blocks: int):
        super().__init__()
        self.reverse_proj = nn.Conv2d(embed_dim, rec_channels, 1)
        for i in range(num_blocks):
            self.add_module(f"block{i}", ConvNeXtBlock(rec_channels))
        self.num_blocks = num_blocks
        self.reembed_proj = nn.Conv2d(rec_channels, embed_dim, 1)
        self.norm = LayerNorm(embed_dim)
        self.beta = nn.Parameter(torch.tensor(0.1))

    def forward(self, tokens: torch.Tensor, hw: Tuple[int, int],
                dtype) -> torch.Tensor:
        b, n, c = tokens.shape
        r = conv_nhwc(self.reverse_proj, tokens.reshape(b, *hw, c), dtype)
        for i in range(self.num_blocks):
            r = getattr(self, f"block{i}")(r, dtype)
        r = conv_nhwc(self.reembed_proj, r, dtype).reshape(b, n, c)
        r = self.norm(r, dtype)
        return tokens + self.beta.to(dtype) * r


class SplitFusion(nn.Module):
    """Gated additive and concat-MLP fusion of ViT and CNN tokens with
    learnable softmax weights, then LN."""

    def __init__(self, embed_dim: int):
        super().__init__()
        self.gate_norm = LayerNorm(embed_dim)
        self.gate_fc = Dense(embed_dim, embed_dim)
        self.cat_fc = Dense(2 * embed_dim, embed_dim)
        self.cat_norm = LayerNorm(embed_dim)
        self.fusion_weights = nn.Parameter(torch.tensor([0.75, 0.25]))
        self.final_norm = LayerNorm(embed_dim)

    def forward(self, t_in: torch.Tensor, r: torch.Tensor,
                dtype) -> torch.Tensor:
        gate = torch.sigmoid(self.gate_fc(self.gate_norm(t_in + r, dtype),
                                          dtype))
        t_add_out = t_in + gate * r
        y = _gelu(self.cat_norm(self.cat_fc(torch.cat([t_in, r], dim=-1),
                                            dtype), dtype))
        t_cat_out = t_in + y
        w = torch.softmax(self.fusion_weights.float(), dim=0).to(t_in.dtype)
        return self.final_norm(w[0] * t_add_out + w[1] * t_cat_out, dtype)
