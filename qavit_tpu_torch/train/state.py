"""The train state: step, optimizer moments, EMA and the bank counter
(counterpart of ``qavit_tpu/train/state.py``).

JAX keeps an immutable TrainState; here the parameters and the
BatchNorm buffers live in the model, and the train step updates them,
the moments and the EMA in place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from qavit_tpu_torch.nn.bank import BankState
from qavit_tpu_torch.train.optim import AdamState, adam_init


@dataclass
class TrainState:
    step: int
    model: nn.Module
    names: List[str]                     # trainable parameters, in order
    opt: AdamState
    ema_params: Optional[Dict[str, torch.Tensor]]
    ema_buffers: Optional[Dict[str, torch.Tensor]]
    bank_count: torch.Tensor             # int32, persistent bank writes
    ema_decay: float

    def params(self) -> List[torch.Tensor]:
        named = dict(self.model.named_parameters())
        return [named[n] for n in self.names]


def create_train_state(model: nn.Module, use_ema: bool = True,
                       ema_decay: float = 0.999) -> TrainState:
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    dev = params[0].device
    ema_p = ({n: p.detach().clone() for n, p in model.named_parameters()}
             if use_ema else None)
    ema_b = ({n: b.detach().clone() for n, b in model.named_buffers()}
             if use_ema else None)
    return TrainState(0, model, names, adam_init(params), ema_p, ema_b,
                      torch.zeros((), dtype=torch.int32, device=dev),
                      float(ema_decay))


@torch.no_grad()
def swap_bank(model: nn.Module, bank: BankState) -> None:
    """Copy the post-forward bank carry into the bank parameters: the
    bank's in-forward update is in the parameters when the optimizer
    steps (``steps.py:107-112``)."""
    gb = model.global_bank
    gb.global_k.copy_(bank.k.detach().to(gb.global_k.dtype))
    gb.global_v.copy_(bank.v.detach().to(gb.global_v.dtype))


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], model: nn.Module,
               decay: float) -> None:
    """EMA of the parameters (HQAViT_CIFAR100.py:139-156)."""
    names = list(ema)
    named = dict(model.named_parameters())
    e = [ema[n] for n in names]
    torch._foreach_mul_(e, decay)
    torch._foreach_add_(e, [named[n].float() for n in names],
                        alpha=1.0 - decay)


@torch.no_grad()
def copy_buffers(dst: Dict[str, torch.Tensor], model: nn.Module) -> None:
    """EMA buffers are copies of the live ones, not averages."""
    for n, b in model.named_buffers():
        dst[n].copy_(b)


def ema_warmup_decay(epoch: int, warmup_epochs: int, decay_warmup: float,
                     decay: float) -> float:
    """Linear decay warmup over the warmup epochs
    (HQAViT_CIFAR100.py:1633-1637)."""
    if warmup_epochs <= 0 or epoch > warmup_epochs:
        return decay
    return decay_warmup + (decay - decay_warmup) * (epoch / warmup_epochs)


@torch.no_grad()
def ema_distance(state: TrainState) -> Tuple[torch.Tensor, torch.Tensor]:
    """L2 distances of the EMA parameters from the live ones and of the
    EMA buffers from the live buffers (HQAViT_CIFAR100.py:158-180), as
    float32 device scalars; the buffer distance is 0 without BatchNorm."""
    model = state.model

    def dist(ema: Dict[str, torch.Tensor], live) -> torch.Tensor:
        total = torch.zeros((), dtype=torch.float32,
                            device=state.bank_count.device)
        for n, t in live:
            if t.is_floating_point():
                d = ema[n].float() - t.float()
                total = total + (d * d).sum()
        return torch.sqrt(total)

    params = dist(state.ema_params, model.named_parameters())
    buffers = dist(state.ema_buffers, model.named_buffers())
    return params, buffers
