"""Model configuration of the QA-ViT / HQA-ViT family.

The port's own copy of ``qavit_tpu/configs/model.py``: the same field
names and defaults, so a preset means one thing in both packages.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Tuple


@dataclass(frozen=True)
class BankConfig:
    """Global token bank behaviour (v2 rule: update clamp +-0.05, rate
    0.005 for the first 1000 writes then 0.01, value clamp +-0.5)."""

    size: int = 16
    update_clamp: float = 0.05
    update_rate_warm: float = 0.005
    update_rate: float = 0.01
    warmup_writes: int = 1000
    value_clamp: float = 0.5


# the v1 rule (QAViT.py:183): rate 0.01, update clamp +-0.1, value clamp
# +-1.0, no warmup counter
BANK_V1 = BankConfig(
    update_clamp=0.1,
    update_rate_warm=0.01,
    update_rate=0.01,
    warmup_writes=0,
    value_clamp=1.0,
)


@dataclass(frozen=True)
class ModelConfig:
    """Hyper-parameters of QAViT / HQAViT models; defaults are the
    HQA-ViT CIFAR-100 flagship."""

    name: str = "hqavit_c100"

    # Input / output
    img_size: int = 32
    patch_size: int = 4
    in_channels: int = 3
    num_classes: int = 100

    # Transformer trunk
    embed_dim: int = 192
    depth: int = 8
    num_heads: int = 4
    compress_ratio: int = 4          # branch compression d -> d/4
    bottleneck_ratio: int = 2        # bottleneck MLP hidden = d/2
    mlp_ratio: float = 0.5           # CCF-FFN hidden = d/2
    dropout: float = 0.1
    drop_path: float = 0.1

    # Branch geometry
    window_size: int = 4
    dilation_factors: Tuple[int, ...] = (1, 2)
    landmark_pooling_stride: int = 2
    msda_pad_len: int = 128          # MSDA pads pooled K/V to this length
    num_channel_groups: int = 6
    linformer_k: int = 32

    # Global token bank
    bank: BankConfig = field(default_factory=BankConfig)

    # Variant flags (v1 = plain, v2 = stabilised)
    stabilized_dwconv: bool = True   # 0.1 per-channel dwconv scale
    stabilized_ccfffn: bool = True   # LN around dwconv + learnable gamma 0.1
    dwconv_bias: bool = False

    # HQA hybrid side path
    hybrid: bool = True
    cnn_c2: int = 64
    cnn_c3: int = 128
    cnn_c4: int = 256
    stem_kind: str = "v1"            # "v1" (conv+BN stem) | "convnext"
    rrcv_channels: int = 64
    rrcv_num_blocks: int = 1
    use_token_learner: bool = True
    num_learned_tokens: int = 16
    stage_blocks: Tuple[int, ...] = (2, 2, 2, 2)

    # activations in this dtype, parameters in float32
    dtype: str = "bfloat16"

    # zero an attention output when its inputs or output hold a NaN
    guard_nans: bool = True
    attn_impl: str = "auto"
    remat: bool = True

    def __post_init__(self):
        if self.embed_dim % self.num_heads:
            raise ValueError("embed_dim must divide num_heads")
        if self.hybrid and sum(self.stage_blocks) != self.depth:
            raise ValueError(
                f"stage_blocks {self.stage_blocks} must sum to depth "
                f"{self.depth}")
        if self.embed_dim % self.num_channel_groups:
            raise ValueError("embed_dim must divide num_channel_groups")

    @property
    def grid_size(self) -> int:
        return self.img_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size ** 2

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ModelConfig":
        """Inverse of :meth:`to_dict`, also of a dict read back from JSON
        (the bank as a dict, tuples as lists)."""
        d = dict(d)
        if isinstance(d.get("bank"), dict):
            d["bank"] = BankConfig(**d["bank"])
        for k in ("dilation_factors", "stage_blocks"):
            if k in d and isinstance(d[k], list):
                d[k] = tuple(d[k])
        return cls(**d)
