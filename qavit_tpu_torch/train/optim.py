"""Learning-rate schedules, the two-level gradient clipping, the LR groups
and AdamW (counterpart of ``qavit_tpu/train/optim.py``).

The optimizer is the JAX package's optax chain written out: Adam
(b1 0.9, b2 0.999, eps 1e-8), then decoupled weight decay on every
parameter outside ``NO_WD_KEYS``, then the LR-group multiplier (which so
scales the weight-decay term too), then the scheduled learning rate
(``optim.py:174-205``).  Parameters are named as ``model.named_parameters``
names them; a name's JAX path is the same with ``/`` for ``.`` and the
block index of ``stage{i}_blocks.{j}`` (HQAViT) or ``blocks.{j}`` (the
flat QAViT) dropped, because the JAX package stacks a stage's blocks into
one scanned leaf (``qavit_tpu/nn/models.py`` ``_scan_stack``).  The
per-tensor pre-clip therefore takes one norm over the blocks of a stack,
as the JAX leaf does.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from qavit_tpu_torch.configs.training import TrainingConfig

# parameters that never receive gradients (the bank write path and each
# writing branch's post-proj LayerNorm): no weight decay
NO_WD_KEYS = ("write_norm", "write_compression", "write_gate",
              "swa/norm/", "msda/norm/", "cga/norm/")
_BLOCK = re.compile(r"(^|\.)(blocks|stage\d+_blocks)\.\d+\.")


def jax_path(name: str) -> str:
    """The JAX leaf path of a parameter name (scan axis merged), also
    under a scope such as SimCLRNet's ``HQAViT_0`` / ``QAViT_0``."""
    return _BLOCK.sub(r"\1\2.", name).replace(".", "/")


def make_schedule(tc: TrainingConfig, steps_per_epoch: int
                  ) -> Callable[[int], float]:
    """onecycle (optax.cosine_onecycle_schedule), cosine with linear
    warmup (optax.warmup_cosine_decay_schedule) or SGDR warm restarts,
    as ``optim.py:42-84`` builds them."""
    total = max(steps_per_epoch * tc.epochs, 2)
    warmup = min(steps_per_epoch * tc.warmup_epochs, total - 1)
    if tc.schedule == "onecycle":
        init = tc.base_lr / tc.onecycle_div_factor
        bounds = (0, int(max(warmup, 1) / total * total), int(total))
        values = (init, tc.base_lr, init / tc.onecycle_final_div)

        def onecycle(step: int) -> float:
            for i in range(2):
                if bounds[i] <= step < bounds[i + 1]:
                    pct = (step - bounds[i]) / (bounds[i + 1] - bounds[i])
                    a, b = values[i], values[i + 1]
                    return b + (a - b) / 2.0 * (math.cos(math.pi * pct) + 1)
            return values[-1]

        return onecycle
    if tc.schedule == "cosine":
        init = tc.base_lr / tc.onecycle_div_factor
        alpha = tc.min_lr / tc.base_lr if tc.base_lr else 0.0
        decay = total - warmup

        def cosine(step: int) -> float:
            if step < warmup:
                return init + (tc.base_lr - init) * step / max(warmup, 1)
            t = min(step - warmup, decay)
            cos = 0.5 * (1 + math.cos(math.pi * t / decay))
            return tc.base_lr * ((1 - alpha) * cos + alpha)

        return cosine
    if tc.schedule == "warm_restarts":
        t0 = steps_per_epoch * tc.warm_restart_t0_epochs
        t_mult = tc.warm_restart_t_mult

        def restarts(step: int) -> float:
            if step < warmup:
                return tc.base_lr * min(step / max(warmup, 1), 1.0)
            s = max(step - warmup, 0.0)
            if t_mult == 1:
                t_cur, t_i = s % t0, float(t0)
            else:
                k = math.floor(math.log(s * (t_mult - 1) / t0 + 1)
                               / math.log(t_mult))
                start = t0 * (t_mult ** k - 1) / (t_mult - 1)
                t_i, t_cur = t0 * t_mult ** k, s - start
            cos = 0.5 * (1 + math.cos(math.pi * t_cur / t_i))
            return tc.min_lr + (tc.base_lr - tc.min_lr) * cos

        return restarts
    raise ValueError(f"unknown schedule {tc.schedule!r}")


def _groups(names: Sequence[str]) -> Dict[str, List[int]]:
    out: Dict[str, List[int]] = {}
    for i, n in enumerate(names):
        out.setdefault(jax_path(n), []).append(i)
    return out


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum((g.float() ** 2).sum() for g in grads))


def apply_clipping(names: Sequence[str], grads: Sequence[torch.Tensor],
                   tc: TrainingConfig
                   ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Per-tensor pre-clip of the ``subtree_clip_keys`` leaves to
    ``subtree_clip_norm``, the monitored global norm, then the global clip
    with its +1e-6 (``optim.py:151-171``).  Returns (grads, norm before
    the global clip)."""
    grads = list(grads)
    if tc.subtree_clip_norm is not None:
        for path, idx in _groups(names).items():
            if not any(k in path for k in tc.subtree_clip_keys):
                continue
            norm = global_norm([grads[i] for i in idx])
            scale = torch.clamp(tc.subtree_clip_norm / (norm + 1e-6), max=1.0)
            for i in idx:
                grads[i] = (grads[i] * scale).to(grads[i].dtype)
    norm = global_norm(grads)
    if tc.grad_clip_mode == "norm":
        scale = torch.clamp(tc.max_grad_norm / (norm + 1e-6), max=1.0)
        grads = [(g * scale).to(g.dtype) for g in grads]
    elif tc.grad_clip_mode == "value":
        grads = [g.clamp(-tc.max_grad_norm, tc.max_grad_norm) for g in grads]
    return grads, norm


def lr_group_multipliers(tc: TrainingConfig
                         ) -> Optional[Callable[[str], float]]:
    """The LR multiplier of a JAX path (``optim.py:112-139``), or None
    without LR groups.  The match is by substring and the first match
    wins, as in JAX, accidental matches included: a CNN-stem path such as
    ``cnn_stem/stage1_conv/weight`` holds ``stage1`` and so takes the
    stage-1 multiplier, not the stem's."""
    if tc.lr_groups is None:
        return None
    if tc.lr_groups == "differential":
        # backbone base LR, head x multiplier (HQAViT_Tiny_Cifar10.py:327)
        return lambda p: tc.head_lr_multiplier if "head" in p else 1.0
    if tc.lr_groups == "layerwise":
        # HQAViT_C100_Finetune.py:188-227
        def mult(p: str) -> float:
            if "head" in p:
                return tc.head_lr_multiplier
            for stage in (4, 3, 2, 1):
                if f"stage{stage}" in p:
                    return tc.layer_lr_decay ** (4 - stage)
            if any(k in p for k in ("fuse", "rrcv", "lmfa")):
                return 0.5
            if "cnn_stem" in p:
                return 0.1
            if any(k in p for k in ("patch_embed", "pos_embed",
                                    "global_bank")):
                return 0.3
            return 1.0

        return mult
    raise ValueError(f"unknown lr_groups {tc.lr_groups!r}")


def tensor_multipliers(names: Sequence[str], tc: TrainingConfig
                       ) -> Optional[List[float]]:
    """Each parameter's LR multiplier, by its JAX path (None without LR
    groups)."""
    mult = lr_group_multipliers(tc)
    return None if mult is None else [mult(jax_path(n)) for n in names]


def format_lr_group_table(names: Sequence[str], tc: TrainingConfig
                          ) -> List[str]:
    """The startup table of ``qavit_tpu/cli/train.py:244-257``, as JAX
    prints it: for each multiplier, largest first, the number of JAX
    leaves that take it (a stack's blocks are one leaf) and the module
    path of the first of them in JAX's leaf order (sorted keys); no lines
    without LR groups."""
    mult = lr_group_multipliers(tc)
    if mult is None:
        return []
    groups: Dict[float, List[str]] = {}
    for path in sorted(_groups(names), key=lambda p: p.split("/")):
        groups.setdefault(mult(path), []).append(path)
    return [f"LR groups ({tc.lr_groups}):"] + [
        f"  x{m:<6g} {len(groups[m]):4d} params  "
        f"(e.g. {groups[m][0].rsplit('/', 1)[0]})"
        for m in sorted(groups, reverse=True)]


def decays(name: str) -> bool:
    path = jax_path(name)
    return not any(k in path for k in NO_WD_KEYS)


@dataclass
class AdamState:
    """optax.scale_by_adam's state: the update count and the moments."""

    count: int = 0
    mu: List[torch.Tensor] = field(default_factory=list)
    nu: List[torch.Tensor] = field(default_factory=list)


def adam_init(params: Sequence[torch.Tensor]) -> AdamState:
    return AdamState(0, [torch.zeros_like(p, dtype=torch.float32)
                         for p in params],
                     [torch.zeros_like(p, dtype=torch.float32)
                      for p in params])


@torch.no_grad()
def adamw_update(params: Sequence[torch.Tensor],
                 grads: Sequence[torch.Tensor], state: AdamState,
                 decay_mask: Sequence[bool], lr: float, weight_decay: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 multipliers: Optional[Sequence[float]] = None) -> None:
    """One step of the chain, in place on ``params`` and ``state``;
    ``multipliers`` are the LR groups' (``tensor_multipliers``)."""
    state.count += 1
    g = [x.float() for x in grads]
    torch._foreach_lerp_(state.mu, g, 1 - b1)
    torch._foreach_mul_(state.nu, b2)
    torch._foreach_addcmul_(state.nu, g, g, 1 - b2)
    c1, c2 = 1 - b1 ** state.count, 1 - b2 ** state.count
    mu_hat = torch._foreach_div(state.mu, c1)
    nu_hat = torch._foreach_div(state.nu, c2)
    denom = torch._foreach_add(torch._foreach_sqrt(nu_hat), eps)
    upd = torch._foreach_div(mu_hat, denom)
    for u, p, m in zip(upd, params, decay_mask):
        if m:
            u.add_(p.float(), alpha=weight_decay)
    if multipliers is not None:
        scaled = [(u, m) for u, m in zip(upd, multipliers) if m != 1.0]
        if scaled:
            torch._foreach_mul_([u for u, _ in scaled],
                                [m for _, m in scaled])
    torch._foreach_add_(list(params), upd, alpha=-lr)
