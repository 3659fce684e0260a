"""Train and eval steps (counterpart of ``qavit_tpu/train/steps.py``).

``make_train_step`` is the JAX package's step for
``gradient_accumulation_steps == 1``: mixup/cutmix, the train forward
(dropout, drop-path, BatchNorm batch statistics, three bank writes per
block), the label-smoothed mixed loss, the backward, the two-level
clipping, the bank carry copied into the parameters, AdamW under the
schedule, and the EMA.  ``make_eval_step`` gives summed plain
cross-entropy, top-1, top-5 and the count, from the live or the EMA
weights.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch.func import functional_call

from qavit_tpu_torch.configs.model import ModelConfig
from qavit_tpu_torch.configs.training import TrainingConfig
from qavit_tpu_torch.kernels.fused_kernels import kernel_geometry_error
from qavit_tpu_torch.kernels.fused_ref import fmix32, make_geom
from qavit_tpu_torch.nn.layers import DropoutRng
from qavit_tpu_torch.train.mix import apply_mix, mixed_loss
from qavit_tpu_torch.train.optim import (adamw_update, apply_clipping, decays,
                                         global_norm)
from qavit_tpu_torch.train.state import (TrainState, copy_buffers, ema_update,
                                         swap_bank)


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP.md "
                              f"{item})")


def check_train_geometry(mc: ModelConfig) -> None:
    """Raise unless the fused units' backward kernels take ``mc``'s block
    geometry (HQAViT; the flat QAViT's train step raises on its own, queue
    1 item 1): n=16 in one SWA window (hqavit_c100) or n=64 in four
    (hqavit_tiny_in, hqavit_proc_tin).  The working dtype is checked at
    each launch: on the card n=64 trains in bf16 only, while the CPU's
    plain units take both dtypes."""
    if not mc.hybrid:
        return
    geom = make_geom(mc)
    err = ("no fused-block geometry" if geom is None
           else kernel_geometry_error(geom, train=True))
    if err is not None:
        _not_ported(f"{mc.name}'s train step: {err}",
                    "queue 2 item 2c, n=196 and n=256")


def step_seed(seed: int, step: int) -> int:
    """The seed of one step's draws (``fold_in(rng, step)``'s role)."""
    return (fmix32(seed & 0xFFFFFFFF) << 32) | fmix32(
        (step * 0x9E3779B1 + seed) & 0xFFFFFFFF)


def loss_and_grads(model: torch.nn.Module, names, images: torch.Tensor,
                   targets: torch.Tensor, seed: int, bank_count,
                   mc: ModelConfig, tc: TrainingConfig):
    """Mix, train forward, mixed loss and the gradients of the parameters
    ``names`` (zeros where a parameter gets none): (loss, logits, bank
    state after the forward, gradients).  ``seed`` fixes every draw."""
    batch = apply_mix(torch.Generator().manual_seed(seed & (2 ** 62 - 1)),
                      images, targets, tc)
    model.train()
    logits, bank = model(batch.images, train=True, bank_count=bank_count,
                         rng=DropoutRng(seed >> 2, images.device))
    loss = mixed_loss(logits, batch, mc.num_classes, tc.label_smoothing)
    named = dict(model.named_parameters())
    params = [named[n] for n in names]
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, params)]
    return loss, logits, bank, grads


def make_train_step(mc: ModelConfig, tc: TrainingConfig,
                    schedule: Callable[[int], float],
                    debug_grads: bool = False) -> Callable:
    """``train_step(state, images, targets, seed) -> metrics``; updates
    ``state`` (and its model) in place.  images: [B, H, W, C] normalised
    float32 on the model's device; targets: [B] int."""
    check_train_geometry(mc)
    if int(getattr(tc, "gradient_accumulation_steps", 1)) > 1:
        _not_ported("gradient_accumulation_steps > 1",
                    "queue 1 item 4 (gradient accumulation)")
    if getattr(tc, "flat_optimizer", False):
        _not_ported("flat_optimizer", "queue 1 item 4 (train/flat_optim)")
    if tc.lr_groups is not None:
        _not_ported("lr_groups", "queue 1 item 4 (layerwise LR groups)")
    if debug_grads:
        _not_ported("debug_grads", "queue 1 item 4 (obs/monitor)")

    def train_step(state: TrainState, images: torch.Tensor,
                   targets: torch.Tensor, seed: int) -> Dict:
        model = state.model
        loss, logits, bank, grads = loss_and_grads(
            model, state.names, images, targets, step_seed(seed, state.step),
            state.bank_count, mc, tc)
        params = state.params()
        grads, grad_norm = apply_clipping(state.names, grads, tc)
        swap_bank(model, bank)
        lr = schedule(state.step)
        adamw_update(params, grads, state.opt,
                     [decays(n) for n in state.names], lr, tc.weight_decay)
        if state.ema_params is not None:
            ema_update(state.ema_params, model, state.ema_decay)
            copy_buffers(state.ema_buffers, model)
        state.step += 1
        state.bank_count = bank.count.detach()
        with torch.no_grad():
            correct = (logits.argmax(-1) == targets).sum()
        return {
            "loss": loss.detach(), "correct": correct,
            "count": targets.shape[0], "grad_norm": grad_norm.detach(),
            "param_norm": (global_norm(params) if tc.log_param_norm
                           else torch.zeros((), device=images.device)),
            "lr": lr, "logits": logits.detach(),
        }

    return train_step


def make_eval_step(model: torch.nn.Module, state: Optional[TrainState] = None,
                   use_ema: bool = False) -> Callable:
    """``eval_step(images, targets) -> metrics`` on the model's device;
    the metrics stay on the device (no host sync).  With ``use_ema`` the
    model runs on ``state``'s EMA parameters and buffers."""
    if use_ema and (state is None or state.ema_params is None):
        raise ValueError("use_ema needs a TrainState with an EMA")

    @torch.inference_mode()
    def eval_step(images: torch.Tensor, targets: torch.Tensor
                  ) -> Dict[str, torch.Tensor]:
        if use_ema:
            logits, _ = functional_call(
                model, {**state.ema_params, **state.ema_buffers}, (images,),
                {"bank_count": state.bank_count})
        else:
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
