"""Shared primitive layers of the QA-ViT family
(counterparts of ``qavit_tpu/nn/layers.py:33-228``).

Layouts follow the JAX package at every public function: tokens are
``[B, N, C]`` and images / feature maps NHWC.  Parameters are float32
and every module computes in the working ``dtype`` it is given.  Dense
layers keep the flax kernel layout ``[in, out]``, which is also what the
CUDA units read; parameter names follow the JAX tree so the weight bridge
(``qavit_tpu_torch/ckpt/from_jax.py``) maps leaf to leaf.

Random initialisation happens in :func:`init_weights`, from an explicit
``torch.Generator``: each module's ``reset_parameters(gen)`` fills its own
parameters with the JAX package's initializers.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from qavit_tpu_torch.kernels import fused_ref as R
from qavit_tpu_torch.nn.dwconv import depthwise_conv2d

LN_EPS = R.LN_EPS
DENSE_STD = 0.02          # normal(0.02) for every Dense, E and bank row


def normal_(t: torch.Tensor, std: float, gen: torch.Generator) -> None:
    with torch.no_grad():
        t.normal_(0.0, std, generator=gen)


class DropoutRng:
    """The random state of one train forward, from one integer seed:
    a ``torch.Generator`` on the activations' device for the dropout and
    drop-path masks outside the fused blocks, one seed per fused block
    (the blocks' masks come from a counter hash, ``fused_ref.block_rng``)
    and one salt per attention dropout of the branch path (the counter-hash
    masks of ``kernels/attention.py``).  None of these is ``jax.random``'s
    draw: the masks differ from JAX's by design (ROADMAP.md, the known
    divergences)."""

    def __init__(self, seed: int, device):
        self.seed = int(seed)
        self.device = torch.device(device)
        self._gen: Optional[torch.Generator] = None
        self._blocks = 0
        self._salts = 0

    def generator(self) -> torch.Generator:
        if self._gen is None:
            self._gen = torch.Generator(device=self.device)
            self._gen.manual_seed(self.seed)
        return self._gen

    def block_seed(self) -> int:
        """The next fused block's seed."""
        self._blocks += 1
        return (self.seed << 20) + self._blocks

    def salt(self) -> int:
        """The next attention dropout's 32-bit salt, a hash of the whole
        seed and a counter (no host sync, unlike a draw from the
        generator)."""
        self._salts += 1
        base = R.fmix32(self.seed & R._M32) ^ R.fmix32(
            (self.seed >> 32) & R._M32 ^ 0x5BD1E995)
        return R.fmix32((base + self._salts * R._GOLDEN) & R._M32)


def keep_mask(shape, rate: float, rng: Optional[DropoutRng],
              device) -> Optional[torch.Tensor]:
    """flax ``nn.Dropout``'s keep mask: True with probability 1 - rate,
    drawn from ``rng``'s generator; None in eval (no ``rng``) or at rate
    0."""
    if rng is None or rate <= 0.0:
        return None
    return torch.rand(shape, generator=rng.generator(), device=device) >= rate


def dropout(x: torch.Tensor, rate: float,
            rng: Optional[DropoutRng]) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 - rate, scale kept
    values by 1 / (1 - rate); the identity without ``rng`` (eval)."""
    return R.dropout(x, rate, keep_mask(x.shape, rate, rng, x.device))


class DropPath(nn.Module):
    """Stochastic depth: one Bernoulli keep per sample, kept samples
    divided by keep_prob rounded to the activations' dtype, as
    ``qavit_tpu/nn/layers.py:33-52`` divides by
    ``keep_prob.astype(x.dtype)``.  The fused blocks draw theirs
    in-kernel; this one serves the rest (the RRCV side path, the branch
    block's tail)."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = float(rate)

    def mask(self, batch: int, dtype: torch.dtype,
             rng: Optional[DropoutRng], device) -> Optional[torch.Tensor]:
        """The prescaled float32 mask [B, 1, 1] (0 or 1 / keep_prob) that
        ``fused_ref.drop_path`` applies; None in eval or at rate 0."""
        if rng is None or self.rate == 0.0:
            return None
        keep = torch.rand((batch, 1, 1), generator=rng.generator(),
                          device=device) >= self.rate
        keep_prob = torch.tensor(R.keep_f32(self.rate), dtype=dtype).float()
        return torch.where(keep, 1.0 / keep_prob.to(device), 0.0)

    def forward(self, x: torch.Tensor,
                rng: Optional[DropoutRng]) -> torch.Tensor:
        m = self.mask(x.shape[0], x.dtype, rng, x.device)
        if m is None:
            return x
        return R.drop_path(x, m.reshape((-1,) + (1,) * (x.dim() - 1)))


class Dense(nn.Module):
    """flax ``nn.Dense``: ``kernel [in, out]``, ``bias [out]``."""

    def __init__(self, in_features: int, features: int,
                 init_std: float = DENSE_STD):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.init_std = init_std

    def reset_parameters(self, gen: torch.Generator) -> None:
        normal_(self.kernel, self.init_std, gen)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return R.dense(x, {"kernel": self.kernel, "bias": self.bias}, dtype)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` (``scale``/``bias``, fast variance)."""

    def __init__(self, features: int, eps: float = LN_EPS):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.eps = eps

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return R.layer_norm(x, {"scale": self.scale, "bias": self.bias},
                            dtype, self.eps)


def conv_std(conv: nn.Conv2d) -> float:
    """kaiming normal, fan_out, relu gain (flax variance_scaling(2,
    "fan_out", "normal"))."""
    kh, kw = conv.kernel_size
    return math.sqrt(2.0 / (conv.out_channels * kh * kw))


def conv_nhwc(conv: nn.Conv2d, x: torch.Tensor, dtype) -> torch.Tensor:
    """Apply an OIHW ``nn.Conv2d`` to an NHWC map in ``dtype``."""
    w = conv.weight.to(dtype)
    b = conv.bias.to(dtype) if conv.bias is not None else None
    y = F.conv2d(x.to(dtype).permute(0, 3, 1, 2), w, b, conv.stride,
                 conv.padding, conv.dilation, conv.groups)
    return y.permute(0, 2, 3, 1)


class PatchEmbed(nn.Module):
    """Non-overlapping patches as reshape + Dense, then LayerNorm.

    The Grad-CAM hook sits on the pre-norm projection, where the reference
    hooks ``model.patch_embed.proj`` (``qavit_tpu/nn/layers.py:53-86``):
    ``perturb``, a zero tensor ``[1, N, C]`` broadcast over the batch, is
    added there, so the gradient of a score with respect to it is the
    hook's gradient; ``pre_norm`` returns that activation.  Without them
    the forward is the projection and the LayerNorm alone."""

    def __init__(self, patch_size: int, in_channels: int, embed_dim: int):
        super().__init__()
        self.patch_size = patch_size
        # flax conv_init on a Dense kernel: fan_out = embed_dim
        self.proj = Dense(patch_size * patch_size * in_channels, embed_dim,
                          init_std=math.sqrt(2.0 / embed_dim))
        self.norm = LayerNorm(embed_dim)

    def forward(self, x: torch.Tensor, dtype,
                perturb: Optional[torch.Tensor] = None,
                pre_norm: bool = False) -> torch.Tensor:
        b, h, w, cin = x.shape
        p = self.patch_size
        x = x.reshape(b, h // p, p, w // p, p, cin).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, (h // p) * (w // p), p * p * cin)
        x = self.proj(x, dtype)
        if perturb is not None:
            x = x + perturb.to(x.dtype)
        return x if pre_norm else self.norm(x, dtype)


class Linformer(nn.Module):
    """LinformerCompression's learned ``E_k``/``E_v`` ``[seq, k]``."""

    def __init__(self, seq_len: int, compressed_len: int):
        super().__init__()
        self.E_k = nn.Parameter(torch.empty(seq_len, compressed_len))
        self.E_v = nn.Parameter(torch.empty(seq_len, compressed_len))

    def reset_parameters(self, gen: torch.Generator) -> None:
        normal_(self.E_k, DENSE_STD, gen)
        normal_(self.E_v, DENSE_STD, gen)


class HybridFusion(nn.Module):
    """Softmax-weighted concat of the four branch outputs (its
    ``fusion_weights``; the arithmetic lives in the block tail)."""

    def __init__(self, num_branches: int = 4):
        super().__init__()
        self.fusion_weights = nn.Parameter(torch.ones(num_branches))


class BottleneckMLP(nn.Module):
    """Dense -> GELU -> dropout -> Dense -> dropout; computed by the block
    tail, whose masks are the ``bn1`` / ``bn2`` keys of the block's
    ``fused_ref.hash_block_masks``."""

    def __init__(self, in_features: int, hidden: int):
        super().__init__()
        self.fc1 = Dense(in_features, hidden)
        self.fc2 = Dense(hidden, in_features)


class DepthwiseConv2d(nn.Module):
    """Depthwise 3x3 over a token grid: a grouped ``nn.Conv2d`` named
    ``dwconv`` plus, when stabilised, a per-channel 0.1 ``scale``."""

    def __init__(self, dim: int, stabilized: bool, use_bias: bool):
        super().__init__()
        self.dwconv = depthwise_conv2d(dim, 3,
                                       bias=use_bias or not stabilized)
        if stabilized:
            self.scale = nn.Parameter(torch.full((dim,), 0.1))


class CCFFFN(nn.Module):
    """Conv-enhanced FFN parameters: fc1 -> GELU -> [LN] -> dwconv ->
    [LN] -> fc2 -> dropout [x gamma]; computed by the block tail (its
    dropout mask is the block's ``ffn`` key)."""

    def __init__(self, embed_dim: int, hidden: int, stabilized: bool,
                 stabilized_dwconv: bool, dwconv_bias: bool):
        super().__init__()
        self.fc1 = Dense(embed_dim, hidden)
        if stabilized:
            self.dwconv_norm = LayerNorm(hidden)
        self.dwconv = DepthwiseConv2d(hidden, stabilized_dwconv, dwconv_bias)
        if stabilized:
            self.post_dwconv_norm = LayerNorm(hidden)
        self.fc2 = Dense(hidden, embed_dim)
        if stabilized:
            self.gamma = nn.Parameter(torch.full((1,), 0.1))


def init_weights(module: nn.Module, gen: torch.Generator) -> nn.Module:
    """Fill every random parameter from ``gen`` (the JAX initializers:
    normal(0.02) for Dense kernels, E matrices and bank rows, kaiming
    fan_out for convs); constants are set by the constructors."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            normal_(m.weight, conv_std(m), gen)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif (type(m).__module__.startswith("qavit_tpu_torch")
              and hasattr(m, "reset_parameters")):
            m.reset_parameters(gen)
    return module


def param_tree(module: nn.Module) -> dict:
    """Nested dict of a module's parameters, shaped like the JAX tree."""
    tree: dict = {}
    for name, t in module.named_parameters():
        node = tree
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = t
    return tree


def resize_pos_embed(pos_embed: torch.Tensor, new_grid: int) -> torch.Tensor:
    """A ``[1, N, C]`` position embedding on a new square grid: bicubic,
    as ``jax.image.resize`` (``nn/resize.py``), when N is a square; else
    JAX's repeat / truncate fallback (``qavit_tpu/nn/layers.py:228-242``;
    reference HQAViT_Tiny_stl10.py:250-283)."""
    from qavit_tpu_torch.nn.resize import resize

    _, n, c = pos_embed.shape
    old_grid = math.isqrt(n)
    new_n = new_grid * new_grid
    if old_grid * old_grid != n:
        if new_n > n:
            reps = new_n // n + 1
            return pos_embed.repeat(1, reps, 1)[:, :new_n]
        return pos_embed[:, :new_n]
    grid = pos_embed.reshape(old_grid, old_grid, c)
    out = resize(grid, (new_grid, new_grid, c), "bicubic")
    return out.reshape(1, new_n, c).to(pos_embed.dtype)
