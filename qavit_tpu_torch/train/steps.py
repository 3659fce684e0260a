"""Train and eval steps (counterpart of ``qavit_tpu/train/steps.py``).

``make_train_step`` is the JAX package's step: mixup/cutmix, the train
forward (dropout, drop-path, BatchNorm batch statistics, three bank
writes per block), the label-smoothed mixed loss, the backward, the
two-level clipping, the bank carry copied into the parameters, AdamW
under the schedule with the LR groups' multipliers, and the EMA.  With
``gradient_accumulation_steps = k > 1`` the batch is split into k
micro-batches whose gradients are averaged before one update
(``steps.py:65-101``); with ``flat_optimizer`` the clipping, AdamW and
the EMA run on raveled vectors (``train/flat_optim.py``); with
``debug_grads`` the metrics carry ``grad_stats``'s per-leaf norms.
``make_eval_step`` gives summed plain cross-entropy, top-1, top-5 and the
count, from the live or the EMA weights.
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
from qavit_tpu_torch.obs.monitor import grad_stats
from qavit_tpu_torch.train.flat_optim import (FlatAdamState, FlatAdamW,
                                              flat_ema_update)
from qavit_tpu_torch.train.mix import apply_mix, mixed_loss
from qavit_tpu_torch.train.optim import (AdamState, adamw_update,
                                         apply_clipping, decays, global_norm,
                                         tensor_multipliers)
from qavit_tpu_torch.train.state import (TrainState, copy_buffers, ema_update,
                                         swap_bank)


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP.md "
                              f"{item})")


def check_train_geometry(mc: ModelConfig) -> None:
    """Raise unless the fused units' backward kernels take the geometry of
    the blocks ``mc`` trains through the fused units: HQAViT's always, the
    flat QAViT's under ``attn_impl="fused_block"`` when ``make_geom``
    covers its grid (``flat_block``).  The kernels take n=16 in one SWA
    window (hqavit_c100), n=64 in four (hqavit_tiny_in, hqavit_proc_tin,
    qavit_v2_extreme_proc100) and n=256 in sixteen
    (qavit_v2_extreme_tin); the flat branch path has no kernel geometry
    to check.  The working dtype is checked at each launch: on the card
    n=64 and n=256 train in bf16 only, while the CPU's plain units take
    both dtypes."""
    fused = mc.hybrid or mc.attn_impl == "fused_block"
    geom = make_geom(mc) if fused else None
    if geom is None and not mc.hybrid:
        return
    err = ("no fused-block geometry" if geom is None
           else kernel_geometry_error(geom, train=True))
    if err is not None:
        _not_ported(f"{mc.name}'s train step: {err}",
                    "queue 2 item 2c, n=196")


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


def accumulated_grads(state: TrainState, images: torch.Tensor,
                      targets: torch.Tensor, seed: int, accum: int,
                      mc: ModelConfig, tc: TrainingConfig):
    """The k micro-forwards of one step (``steps.py:75-101``): the batch's
    first ``k * (B // k)`` samples in k slices (the remainder is dropped),
    each forward on the same parameters with BatchNorm's running
    statistics and the bank's count advancing, the gradients summed and
    divided by k.  Every micro-forward reads the bank rows of the
    parameters, and the bank carry returned is the last one's: JAX's
    ``scan`` carries only the count, so the row writes of micro-batches
    1..k-1 are lost there and here (ROADMAP.md, the known defects of the
    JAX reference).  Returns (mean loss, logits of the kept samples, bank
    state, gradients, correct count)."""
    micro = images.shape[0] // accum
    if micro == 0:
        raise ValueError(f"a batch of {images.shape[0]} cannot be split "
                         f"into {accum} micro-batches")
    total, logits, correct, count = None, [], 0, state.bank_count
    for i in range(accum):
        part = slice(i * micro, (i + 1) * micro)
        # micro-batch i's draws: ``i`` folded into the step's seed, as JAX
        # folds it into the step's key
        loss, lg, bank, grads = loss_and_grads(
            state.model, state.names, images[part], targets[part],
            step_seed(seed, i), count, mc, tc)
        count = bank.count
        if total is None:
            total, loss_sum = list(grads), loss.detach()
        else:
            torch._foreach_add_(total, grads)
            loss_sum = loss_sum + loss.detach()
        logits.append(lg.detach())
        with torch.no_grad():
            correct = correct + (lg.argmax(-1) == targets[part]).sum()
    torch._foreach_div_(total, accum)
    return loss_sum / accum, torch.cat(logits), bank, total, correct


class _Layout:
    """What a step needs of one parameter list, built at its first step:
    the weight-decay mask, the LR-group multipliers and, with the flat
    optimizer, its vectors."""

    def __init__(self, state: TrainState, tc: TrainingConfig, flat: bool):
        self.key = (tuple(state.names), state.bank_count.device)
        self.decay = [decays(n) for n in state.names]
        self.mults = tensor_multipliers(state.names, tc)
        self.flat = (FlatAdamW(state.names, state.params(), tc) if flat
                     else None)


def _check_opt_state(state: TrainState, flat: bool) -> None:
    want = FlatAdamState if flat else AdamState
    if not isinstance(state.opt, want):
        raise TypeError(
            f"flat_optimizer={flat} needs a {want.__name__} "
            f"(create_train_state(..., flat={flat})), the state holds a "
            f"{type(state.opt).__name__}")
    if flat and state.ema_params is not None and state.ema_flat is None:
        raise TypeError("flat_optimizer needs the raveled EMA of "
                        "create_train_state(..., flat=True)")


def make_train_step(mc: ModelConfig, tc: TrainingConfig,
                    schedule: Callable[[int], float],
                    debug_grads: bool = False) -> Callable:
    """``train_step(state, images, targets, seed) -> metrics``; updates
    ``state`` (and its model) in place.  images: [B, H, W, C] normalised
    float32 on the model's device; targets: [B] int.  The state must come
    from ``create_train_state(..., flat=tc.flat_optimizer)``."""
    check_train_geometry(mc)
    accum = max(int(getattr(tc, "gradient_accumulation_steps", 1)), 1)
    flat = bool(getattr(tc, "flat_optimizer", False))
    tensor_multipliers([], tc)          # an unknown lr_groups raises here
    layouts = []

    def train_step(state: TrainState, images: torch.Tensor,
                   targets: torch.Tensor, seed: int) -> Dict:
        _check_opt_state(state, flat)
        key = (tuple(state.names), state.bank_count.device)
        if not layouts or layouts[0].key != key:
            layouts[:] = [_Layout(state, tc, flat)]
        lay = layouts[0]
        model = state.model
        s = step_seed(seed, state.step)
        if accum == 1:
            loss, logits, bank, grads = loss_and_grads(
                model, state.names, images, targets, s, state.bank_count,
                mc, tc)
            with torch.no_grad():
                correct = (logits.argmax(-1) == targets).sum()
        else:
            loss, logits, bank, grads, correct = accumulated_grads(
                state, images, targets, s, accum, mc, tc)
        params = state.params()
        lr = schedule(state.step)
        stats = None
        if flat:
            # the clip lives inside the update: the stats see the
            # gradients before it (steps.py:142-147)
            if debug_grads:
                stats = grad_stats(state.names, grads)
            swap_bank(model, bank)
            new = lay.flat.update(params, grads, state.opt,
                                  schedule(state.opt.count))
            grad_norm = state.opt.grad_norm
            if state.ema_params is not None:
                flat_ema_update(state.ema_flat, new, state.ema_decay)
                copy_buffers(state.ema_buffers, model)
            param_norm = state.opt.param_norm
        else:
            grads, grad_norm = apply_clipping(state.names, grads, tc)
            if debug_grads:
                stats = grad_stats(state.names, grads)
            swap_bank(model, bank)
            adamw_update(params, grads, state.opt, lay.decay, lr,
                         tc.weight_decay, multipliers=lay.mults)
            if state.ema_params is not None:
                ema_update(state.ema_params, model, state.ema_decay)
                copy_buffers(state.ema_buffers, model)
            param_norm = global_norm(params) if tc.log_param_norm else None
        state.step += 1
        state.bank_count = bank.count.detach()
        metrics = {
            "loss": loss.detach(), "correct": correct,
            "count": targets.shape[0], "grad_norm": grad_norm.detach(),
            "param_norm": (param_norm if tc.log_param_norm
                           else torch.zeros((), device=images.device)),
            "lr": lr, "logits": logits.detach(),
        }
        if stats is not None:
            metrics["per_leaf"] = stats["per_leaf"]
        return metrics

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
