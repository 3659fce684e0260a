"""Eval step (counterpart of ``qavit_tpu/train/steps.py:168-198``
``make_eval_step``): summed plain cross-entropy, top-1, top-5 and the
count, for aggregation by :func:`qavit_tpu_torch.eval.metrics.evaluate`.
The train step comes with the training slice."""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F


def make_eval_step(model: torch.nn.Module) -> Callable:
    """``eval_step(images, targets) -> metrics`` on the model's device;
    the metrics stay on the device (no host sync)."""

    @torch.inference_mode()
    def eval_step(images: torch.Tensor, targets: torch.Tensor
                  ) -> Dict[str, torch.Tensor]:
        logits, _ = model(images)
        loss = F.cross_entropy(logits.float(), targets.long(),
                               reduction="none")
        top5 = logits.topk(5, dim=-1).indices
        return {
            "loss_sum": loss.sum(),
            "top1": (logits.argmax(-1) == targets).sum(),
            "top5": (top5 == targets[:, None]).any(-1).sum(),
            "count": torch.tensor(targets.shape[0]),
            "logits": logits,
        }

    return eval_step
