"""Evaluation aggregation (counterpart of ``qavit_tpu/eval/metrics.py:18``
``evaluate``).  Sums stay on the device until the loop ends, so the
batches queue on the card without a sync each."""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional

import torch


def evaluate(eval_step: Callable, loader: Iterable,
             preprocess: Optional[Callable] = None) -> Dict:
    """Average loss and top-1 / top-5 percentages over ``loader``'s
    ``(images, labels)`` batches."""
    sums: Dict[str, torch.Tensor] = {}
    for images, labels in loader:
        if preprocess is not None:
            images = preprocess(images)
        m = eval_step(images, labels)
        for k in ("loss_sum", "top1", "top5"):
            sums[k] = sums[k] + m[k] if k in sums else m[k]
        sums["count"] = sums.get("count", 0) + int(m["count"])
    count = max(int(sums.get("count", 0)), 1)
    return {
        "loss": float(sums.get("loss_sum", 0.0)) / count,
        "top1": 100.0 * float(sums.get("top1", 0)) / count,
        "top5": 100.0 * float(sums.get("top5", 0)) / count,
        "count": int(sums.get("count", 0)),
    }
