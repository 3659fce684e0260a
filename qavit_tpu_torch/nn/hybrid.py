"""HQA-ViT hybrid CNN side path (counterpart of ``qavit_tpu/nn/hybrid.py``):
ConvNeXtBlock (:21, with the v2 stem's LayerScale ``gamma``), the v1
conv/BN stem CNNStemV1 (:49-92), SpatialLayerNorm (:95), the v2
ConvNeXt-patchify stem CNNStemConvNeXt (:116), LMFAdapter (:157), RRCV
(:187) and SplitFusion (:215).  Feature maps are NHWC, as in the JAX
package; each convolution runs as an OIHW ``nn.Conv2d`` through
:func:`conv_nhwc`.  In training (an ``rng`` given) the v1 stem's
BatchNorm normalises with the batch statistics and updates its running
statistics as flax does, the ConvNeXt blocks drop paths at their rates,
and SplitFusion drops out its concat branch.  LMFA resamples a map that
is off the token grid bilinearly, as ``jax.image.resize`` does
(``nn/resize.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from qavit_tpu_torch.nn.dwconv import depthwise_conv2d
from qavit_tpu_torch.nn.layers import (Dense, DropoutRng, DropPath, LayerNorm,
                                       conv_nhwc, dropout)
from qavit_tpu_torch.nn.resize import resize

BN_MOMENTUM = 0.9        # flax: running = 0.9 * running + 0.1 * batch


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x.float()).to(x.dtype)


class ConvNeXtBlock(nn.Module):
    """dw7x7 -> LN(eps 1e-6) -> Dense 4x -> GELU -> Dense [-> x gamma,
    LayerScale from ``layer_scale_init``] -> drop path -> residual."""

    def __init__(self, dim: int, drop_path: float = 0.0,
                 layer_scale_init: Optional[float] = None):
        super().__init__()
        self.dwconv = depthwise_conv2d(dim, 7)
        self.norm = LayerNorm(dim, eps=1e-6)
        self.pwconv1 = Dense(dim, 4 * dim)
        self.pwconv2 = Dense(4 * dim, dim)
        if layer_scale_init is not None:       # 1e-6 in the v2 stem
            self.gamma = nn.Parameter(torch.full((dim,), layer_scale_init))
        # the v1 stem and RRCV keep the flax block's default rate, 0
        self.drop_path = DropPath(drop_path)

    def forward(self, x: torch.Tensor, dtype,
                rng: Optional[DropoutRng] = None) -> torch.Tensor:
        y = self.norm(conv_nhwc(self.dwconv, x, dtype), dtype)
        y = self.pwconv2(_gelu(self.pwconv1(y, dtype)), dtype)
        if hasattr(self, "gamma"):
            y = y * self.gamma.to(y.dtype)
        return x + self.drop_path(y, rng)


class CNNStemV1(nn.Module):
    """v1 lateral CNN: conv/BN stem and 1x1-projected stages, 32x32 ->
    16x16 -> 8x8; returns F2/F3/F4 as NHWC maps.  BatchNorm runs on its
    running statistics in eval and on the batch's in training."""

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
    def _bn(bn: nn.BatchNorm2d, x: torch.Tensor,
            train: bool = False) -> torch.Tensor:
        # NHWC: the channel axis is last; float32 statistics
        if not train:
            y = F.batch_norm(x.float().permute(0, 3, 1, 2), bn.running_mean,
                             bn.running_var, bn.weight, bn.bias, False, 0.0,
                             bn.eps)
            return y.permute(0, 2, 3, 1).to(x.dtype)
        # flax nn.BatchNorm(use_running_average=False): the batch mean and
        # the biased variance E[x^2] - mean^2; the running statistics take
        # the same biased variance (torch's own update would take the
        # unbiased one)
        xf = x.float()
        mean = xf.mean((0, 1, 2))
        var = ((xf * xf).mean((0, 1, 2)) - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            bn.running_mean.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * mean)
            bn.running_var.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * var)
        y = (xf - mean) * (torch.rsqrt(var + bn.eps) * bn.weight) + bn.bias
        return y.to(x.dtype)

    def forward(self, x: torch.Tensor, dtype,
                rng: Optional[DropoutRng] = None):
        tr = rng is not None
        y = _gelu(self._bn(self.stem_bn, conv_nhwc(self.stem_conv, x, dtype),
                           tr))
        y = _gelu(self._bn(self.stage1_bn,
                           conv_nhwc(self.stage1_conv, y, dtype), tr))
        f2 = self.stage1_block(y, dtype, rng)
        y = self._bn(self.stage2_bn, conv_nhwc(self.stage2_conv, f2, dtype),
                     tr)
        f3 = self.stage2_block(y, dtype, rng)
        y = self._bn(self.stage3_bn, conv_nhwc(self.stage3_conv, f3, dtype),
                     tr)
        f4 = self.stage3_block(y, dtype, rng)
        return f2, f3, f4


class SpatialLayerNorm(nn.Module):
    """torch ``nn.LayerNorm([C, H, W])``: each sample normalised over all
    of (H, W, C) in float32 (population variance), then a per-position
    affine ``scale`` / ``bias`` of shape [H, W, C]."""

    def __init__(self, h: int, w: int, c: int, eps: float = 1e-6):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(h, w, c))
        self.bias = nn.Parameter(torch.zeros(h, w, c))
        self.eps = eps

    def forward(self, x: torch.Tensor, dtype) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean((1, 2, 3), keepdim=True)
        var = (xf - mean).square().mean((1, 2, 3), keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return (y * self.scale + self.bias).to(dtype)


class CNNStemConvNeXt(nn.Module):
    """v2 ConvNeXt-Tiny-style lateral CNN: a 4x4 stride-4 patchify conv and
    a SpatialLayerNorm, then stages of LayerScale ConvNeXt blocks (2 at
    c2; 3 at c3 with drop-path rates 0, 0.1, 0.1; 2 at c4 at 0.1 each),
    each later stage entered through a SpatialLayerNorm and a 1x1 conv.
    All three maps are (img_size / 4)^2; no BatchNorm."""

    LAYER_SCALE = 1e-6

    def __init__(self, c2: int, c3: int, c4: int, in_channels: int = 3,
                 img_size: int = 32):
        super().__init__()
        hw, ls = img_size // 4, self.LAYER_SCALE
        self.stem_conv = nn.Conv2d(in_channels, c2, 4, stride=4)
        self.stem_norm = SpatialLayerNorm(hw, hw, c2)
        for i in range(2):
            self.add_module(f"stage2_block{i}", ConvNeXtBlock(c2, 0.0, ls))
        self.down2_norm = SpatialLayerNorm(hw, hw, c2)
        self.down2_conv = nn.Conv2d(c2, c3, 1)
        for i, dp in enumerate((0.0, 0.1, 0.1)):
            self.add_module(f"stage3_block{i}", ConvNeXtBlock(c3, dp, ls))
        self.down3_norm = SpatialLayerNorm(hw, hw, c3)
        self.down3_conv = nn.Conv2d(c3, c4, 1)
        for i, dp in enumerate((0.1, 0.1)):
            self.add_module(f"stage4_block{i}", ConvNeXtBlock(c4, dp, ls))

    def forward(self, x: torch.Tensor, dtype,
                rng: Optional[DropoutRng] = None):
        y = self.stem_norm(conv_nhwc(self.stem_conv, x, dtype), dtype)
        for i in range(2):
            y = getattr(self, f"stage2_block{i}")(y, dtype, rng)
        f2 = y
        y = conv_nhwc(self.down2_conv, self.down2_norm(f2, dtype), dtype)
        for i in range(3):
            y = getattr(self, f"stage3_block{i}")(y, dtype, rng)
        f3 = y
        y = conv_nhwc(self.down3_conv, self.down3_norm(f3, dtype), dtype)
        for i in range(2):
            y = getattr(self, f"stage4_block{i}")(y, dtype, rng)
        return f2, f3, y


class LMFAdapter(nn.Module):
    """CNN map -> tokens: {dw3x3, dw5x5, identity} concat -> 1x1 proj ->
    bilinear resize to the token grid (when the map is off it) -> LN ->
    GELU."""

    def __init__(self, in_channels: int, embed_dim: int, target_hw: int):
        super().__init__()
        self.target_hw = target_hw
        self.dwconv_3x3 = depthwise_conv2d(in_channels, 3)
        self.dwconv_5x5 = depthwise_conv2d(in_channels, 5)
        self.proj = nn.Conv2d(3 * in_channels, embed_dim, 1)
        self.norm = LayerNorm(embed_dim)

    def forward(self, feat: torch.Tensor, dtype) -> torch.Tensor:
        b, h, w, _ = feat.shape
        t = self.target_hw
        f1 = conv_nhwc(self.dwconv_3x3, feat, dtype)
        f2 = conv_nhwc(self.dwconv_5x5, feat, dtype)
        f_cat = torch.cat([f1, f2, feat.to(dtype)], dim=-1)
        f_proj = conv_nhwc(self.proj, f_cat, dtype)
        if h != t or w != t:
            f_proj = resize(f_proj, (b, t, t, f_proj.shape[-1]), "bilinear")
        tokens = f_proj.reshape(b, t * t, -1)
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
                dtype, rng: Optional[DropoutRng] = None) -> torch.Tensor:
        b, n, c = tokens.shape
        r = conv_nhwc(self.reverse_proj, tokens.reshape(b, *hw, c), dtype)
        for i in range(self.num_blocks):
            r = getattr(self, f"block{i}")(r, dtype, rng)
        r = conv_nhwc(self.reembed_proj, r, dtype).reshape(b, n, c)
        r = self.norm(r, dtype)
        return tokens + self.beta.to(dtype) * r


class SplitFusion(nn.Module):
    """Gated additive and concat-MLP fusion of ViT and CNN tokens with
    learnable softmax weights, then LN; dropout on the concat branch in
    training."""

    def __init__(self, embed_dim: int, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.gate_norm = LayerNorm(embed_dim)
        self.gate_fc = Dense(embed_dim, embed_dim)
        self.cat_fc = Dense(2 * embed_dim, embed_dim)
        self.cat_norm = LayerNorm(embed_dim)
        self.fusion_weights = nn.Parameter(torch.tensor([0.75, 0.25]))
        self.final_norm = LayerNorm(embed_dim)

    def forward(self, t_in: torch.Tensor, r: torch.Tensor, dtype,
                rng: Optional[DropoutRng] = None) -> torch.Tensor:
        gate = torch.sigmoid(self.gate_fc(self.gate_norm(t_in + r, dtype),
                                          dtype))
        t_add_out = t_in + gate * r
        y = _gelu(self.cat_norm(self.cat_fc(torch.cat([t_in, r], dim=-1),
                                            dtype), dtype))
        y = dropout(y, self.dropout, rng)
        t_cat_out = t_in + y
        w = torch.softmax(self.fusion_weights.float(), dim=0).to(t_in.dtype)
        return self.final_norm(w[0] * t_add_out + w[1] * t_cat_out, dtype)
