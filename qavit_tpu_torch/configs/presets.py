"""Presets the port serves (its own copy of ``qavit_tpu/configs/
presets.py``, limited to what the port runs)."""

from __future__ import annotations

from dataclasses import dataclass

from qavit_tpu_torch.configs.model import BANK_V1, BankConfig, ModelConfig
from qavit_tpu_torch.configs.training import TrainingConfig


@dataclass(frozen=True)
class Preset:
    model: ModelConfig
    train: TrainingConfig
    dataset: str


def _qavit_224_v1() -> Preset:
    """QAViT v1 @224 (QAViT.py:37-94): plain dwconv/CCFFFN, bank v1."""
    model = ModelConfig(
        name="qavit_224_v1",
        img_size=224, patch_size=16, num_classes=100,
        embed_dim=192, depth=8, num_heads=4,
        window_size=7, dilation_factors=(1, 2, 3), linformer_k=64,
        bank=BANK_V1,
        stabilized_dwconv=False, stabilized_ccfffn=False,
        hybrid=False, use_token_learner=False, stage_blocks=(8,),
    )
    train = TrainingConfig(
        batch_size=64, epochs=200, warmup_epochs=10, base_lr=1e-3,
        min_lr=1e-5, weight_decay=0.05, label_smoothing=0.1,
        max_grad_norm=1.0, subtree_clip_norm=None, use_ema=False,
        use_mixup=False, use_cutmix=False,
    )
    return Preset(model, train, "cifar100_224")


def _qavit_v2() -> Preset:
    """QAViTv2 @224 (QAViTv2.py:1011): stabilised dwconv/CCFFFN, bank v2,
    and the dwconv bias its stabilised form keeps (QAViTv2.py:861)."""
    p = _qavit_224_v1()
    model = p.model.replace(
        name="qavit_v2", bank=BankConfig(),
        stabilized_dwconv=True, stabilized_ccfffn=True, dwconv_bias=True,
    )
    return Preset(model, p.train, "cifar100_224")


def _qavit_224_v1_proc() -> Preset:
    """The v1 224 recipe on the proc224 substrate (QAViT.py:705-752)."""
    p = _qavit_224_v1()
    return Preset(p.model.replace(name="qavit_224_v1_proc"),
                  p.train.replace(batch_size=256), "proc224")


def _qavit_v2_proc224() -> Preset:
    """QAViTv2 @224 (QAViTv2.py:1011 knobs) on the proc224 substrate."""
    p = _qavit_v2()
    return Preset(p.model.replace(name="qavit_v2_proc224"),
                  p.train.replace(batch_size=256), "proc224")


def _hqavit_c100() -> Preset:
    """HQA-ViT CIFAR-100 flagship (HQAViT_CIFAR100.py:43-123)."""
    return Preset(ModelConfig(name="hqavit_c100"), TrainingConfig(),
                  "cifar100_hqa")


PRESETS = {
    "qavit_224_v1": _qavit_224_v1,
    "qavit_v2": _qavit_v2,
    "qavit_224_v1_proc": _qavit_224_v1_proc,
    "qavit_v2_proc224": _qavit_v2_proc224,
    "hqavit_c100": _hqavit_c100,
}


def get_preset(name: str) -> Preset:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; available: "
                       f"{sorted(PRESETS)}")
    return PRESETS[name]()
