"""Gradient monitoring on the host: norm history, explosion alerts
(threshold 50) and the NaN check (counterpart of the host part of
``qavit_tpu/obs/monitor.py``: ``GradientMonitor`` :39-78,
``check_for_nan`` :80-84).

The in-step per-parameter statistics (``grad_stats``, ``--debug-grads``)
wait for ROADMAP.md queue 1 item 4; without them ``per_leaf`` stays
empty and ``top_layers`` has nothing to rank.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple


class GradientMonitor:
    """Host-side tracker mirroring the reference's API: log norms, count
    explosions (threshold 50, HQAViT_CIFAR100.py:244-250), report the
    worst layers."""

    def __init__(self, explosion_threshold: float = 50.0):
        self.grad_norms: List[float] = []
        self.param_norms: List[float] = []
        self.explosion_count = 0
        self.threshold = explosion_threshold
        self.layer_grad_history: Dict[str, List[float]] = {}

    def log(self, grad_norm: float, param_norm: float,
            per_leaf: Optional[Dict[str, float]] = None) -> bool:
        self.grad_norms.append(float(grad_norm))
        self.param_norms.append(float(param_norm))
        if per_leaf:
            for name, norm in per_leaf.items():
                layer = "/".join(name.split("/")[:2])
                self.layer_grad_history.setdefault(layer, []).append(
                    float(norm))
        exploding = self.grad_norms[-1] > self.threshold
        if exploding:
            self.explosion_count += 1
        return exploding

    def top_layers(self, k: int = 10) -> List[Tuple[str, float]]:
        latest = {name: hist[-1]
                  for name, hist in self.layer_grad_history.items() if hist}
        return sorted(latest.items(), key=lambda kv: -kv[1])[:k]

    def print_stats(self, epoch: int, step: int) -> None:
        if not self.grad_norms:
            return
        g, p = self.grad_norms[-1], self.param_norms[-1]
        print(f"[Epoch {epoch}, Step {step}] Gradient Stats:")
        print(f"  Grad Norm: {g:.4f}")
        print(f"  Param Norm: {p:.4f}")
        print(f"  Grad/Param Ratio: {g / max(p, 1e-8):.4f}")


def check_for_nan(loss: float) -> bool:
    """True where ``loss`` is NaN or infinite (HQAViT_Tiny_stl10.py:285-292).
    As in the JAX package, the train loop does not call it."""
    return math.isnan(loss) or math.isinf(loss)
