"""Presets the port serves (its own copy of ``qavit_tpu/configs/
presets.py``, limited to what the port runs)."""

from __future__ import annotations

from dataclasses import dataclass

from qavit_tpu_torch.configs.model import ModelConfig


@dataclass(frozen=True)
class Preset:
    model: ModelConfig
    dataset: str


def _hqavit_c100() -> Preset:
    """HQA-ViT CIFAR-100 flagship (HQAViT_CIFAR100.py:43-123)."""
    return Preset(ModelConfig(name="hqavit_c100"), "cifar100_hqa")


PRESETS = {"hqavit_c100": _hqavit_c100}


def get_preset(name: str) -> Preset:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; available: "
                       f"{sorted(PRESETS)}")
    return PRESETS[name]()
