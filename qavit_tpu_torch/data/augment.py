"""Eval-time preprocessing (counterpart of ``qavit_tpu/data/augment.py:
454-462`` ``eval_batch``): uint8 NHWC -> normalised float32 NHWC on the
device.  The resize of the 224 pipelines waits for the 224 slice."""

from __future__ import annotations

from typing import Sequence

import torch


def normalize(img01: torch.Tensor, mean: Sequence[float],
              std: Sequence[float]) -> torch.Tensor:
    m = torch.tensor(mean, dtype=img01.dtype, device=img01.device)
    s = torch.tensor(std, dtype=img01.dtype, device=img01.device)
    return (img01 - m) / s


def eval_batch(images_u8: torch.Tensor, mean: Sequence[float],
               std: Sequence[float]) -> torch.Tensor:
    """Validation path: normalise (HQAViT_CIFAR100.py:1304-1307)."""
    return normalize(images_u8.float() / 255.0, mean, std)
