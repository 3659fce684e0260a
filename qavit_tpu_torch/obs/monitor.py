"""Gradient monitoring (counterpart of ``qavit_tpu/obs/monitor.py``): the
in-step statistics ``grad_stats`` (:21-36, ``--debug-grads``), and on the
host the norm history, explosion alerts (threshold 50), the ranking of
the layers (``GradientMonitor`` :39-78) and the NaN check
(``check_for_nan`` :80-84).
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from qavit_tpu_torch.train.optim import _groups


@lru_cache(maxsize=8)
def _leaf_layout(names: Tuple[str, ...], device=None):
    """(JAX leaf paths in JAX's leaf order, sorted keys; [L, width] member
    rows on ``device``, padded with an index to a zero) of a parameter
    list; kept, so that a step copies nothing to the device."""
    groups = _groups(names)
    paths = sorted(groups, key=lambda p: p.split("/"))
    width = max(len(idx) for idx in groups.values())
    rows = [groups[p] + [len(names)] * (width - len(groups[p]))
            for p in paths]
    return paths, torch.tensor(rows, dtype=torch.long, device=device)


def leaf_names(names: Sequence[str]) -> List[str]:
    """The JAX leaf paths that ``grad_stats``'s ``per_leaf`` rows follow
    (``optim.jax_path``: a Conv2d's or BatchNorm's ``weight`` where JAX
    says ``kernel`` or ``scale``)."""
    return _leaf_layout(tuple(names))[0]


@torch.no_grad()
def grad_stats(names: Sequence[str], grads: Sequence[torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
    """Per-JAX-leaf gradient norms (a stack's blocks merged), their
    global norm and NaN / Inf flags, all on the gradients' device with no
    host sync: ``per_leaf`` is one ``[L]`` float32 tensor in the order of
    :func:`leaf_names`."""
    norms = torch.stack(torch._foreach_norm(list(grads))).float()
    _, rows = _leaf_layout(tuple(names), norms.device)
    sq = torch.cat([norms.square(), norms.new_zeros(1)])
    per_leaf_sq = sq[rows].sum(1)
    flat = torch.cat([g.reshape(-1) for g in grads])
    return {"per_leaf": per_leaf_sq.sqrt(),
            "global_norm": per_leaf_sq.sum().sqrt(),
            "has_nan": flat.isnan().any(), "has_inf": flat.isinf().any()}


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
