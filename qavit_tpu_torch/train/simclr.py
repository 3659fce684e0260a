"""SimCLR contrastive pretraining (counterpart of
``qavit_tpu/train/simclr.py`` and of the optimizer that
``qavit_tpu/cli/pretrain_simclr.py:88-100`` builds).

``SimCLRNet`` is the backbone's pooled features (float32) and a
projection head ``proj_fc1`` -> ReLU -> ``proj_fc2`` (128-d) in float32
with flax's default Dense init (``lecun_normal``: a normal truncated at
two standard deviations, variance 1 / fan_in).  The backbone is the
attribute ``HQAViT_0`` (or ``QAViT_0``) and has no classifier head, so
the parameter names are JAX's paths (``HQAViT_0/stage1_blocks/...``) and
the weight bridge maps the JAX tree leaf for leaf.

The train step is JAX's ``make_simclr_train_step``: one train forward
over ``[view1; view2]`` (the BatchNorm statistics of the 2B batch, the
bank written and its count carried), NT-Xent, the bank carry copied into
the parameters, then SimCLR's own optimizer: the global norm clipped to
1.0 (optax ``clip_by_global_norm``), AdamW with weight decay 1e-6 on
every parameter (no mask: the bank's write parameters decay too) at
``simclr_schedule`` evaluated at the optimizer's count; no LR groups,
no subtree pre-clip, no EMA.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn as nn

from qavit_tpu_torch.configs.model import ModelConfig
from qavit_tpu_torch.device import resolve_device
from qavit_tpu_torch.nn.layers import Dense, DropoutRng, init_weights
from qavit_tpu_torch.nn.models import HQAViT, QAViT
from qavit_tpu_torch.train.optim import adamw_update, global_norm
from qavit_tpu_torch.train.state import TrainState, swap_bank
from qavit_tpu_torch.train.steps import step_seed

PROJ_DIM = 128
LECUN_TRUNC = 0.87962566103423978    # std of N(0, 1) truncated to (-2, 2)
MAX_GRAD_NORM = 1.0
WEIGHT_DECAY = 1e-6
END_LR = 1e-6


class ProjDense(Dense):
    """flax ``nn.Dense`` with its default init: ``lecun_normal`` kernel,
    zero bias."""

    def reset_parameters(self, gen: torch.Generator) -> None:
        std = math.sqrt(1.0 / self.kernel.shape[0]) / LECUN_TRUNC
        with torch.no_grad():
            nn.init.trunc_normal_(self.kernel, 0.0, std, -2 * std, 2 * std,
                                  generator=gen)
            self.bias.zero_()


class SimCLRNet(nn.Module):
    """Backbone features + the projection MLP (hidden = embed_dim, out
    ``proj_dim``), both in float32."""

    def __init__(self, cfg: ModelConfig, proj_dim: int = PROJ_DIM):
        super().__init__()
        self.cfg = cfg
        backbone = (HQAViT if cfg.hybrid else QAViT)(cfg)
        del backbone.head                 # return_features never reaches it
        # the flax scope of the backbone inside SimCLRNet
        self.scope = "HQAViT_0" if cfg.hybrid else "QAViT_0"
        self.add_module(self.scope, backbone)
        self.proj_fc1 = ProjDense(cfg.embed_dim, cfg.embed_dim)
        self.proj_fc2 = ProjDense(cfg.embed_dim, proj_dim)

    @property
    def backbone(self) -> nn.Module:
        return getattr(self, self.scope)

    @property
    def global_bank(self) -> nn.Module:
        """The backbone's bank (``train/state.py`` ``swap_bank`` reads
        it, as JAX's ``swap_bank`` searches ``HQAViT_0/global_bank``)."""
        return self.backbone.global_bank

    def forward(self, x: torch.Tensor, train: bool = False, bank_count=0,
                rng: Optional[DropoutRng] = None):
        """(projections [B, proj_dim] float32, the bank state)."""
        feats, bank = self.backbone(x, train=train, bank_count=bank_count,
                                    rng=rng, return_features=True)
        h = torch.relu(self.proj_fc1(feats, torch.float32))
        return self.proj_fc2(h, torch.float32), bank


def build_simclr(cfg: ModelConfig, device="cuda", seed: int = 0
                 ) -> SimCLRNet:
    """A SimCLRNet on ``device`` with weights from a CPU generator seeded
    with ``seed`` (the same weights on every device)."""
    gen = torch.Generator().manual_seed(seed)
    model = init_weights(SimCLRNet(cfg), gen)
    return model.to(resolve_device(device)).eval()


def nt_xent_loss(z: torch.Tensor, temperature: float = 0.5) -> torch.Tensor:
    """NT-Xent over 2B projections ordered [view1; view2]: rows
    normalised (+1e-8 on the norm), self-similarity masked with -1e9,
    the positive of row i is row i + B (mod 2B)."""
    z = z.float()
    z = z / (z.norm(dim=-1, keepdim=True) + 1e-8)
    n = z.shape[0]
    b = n // 2
    eye = torch.eye(n, device=z.device, dtype=z.dtype)
    sim = (z @ z.T) / temperature - 1e9 * eye
    pos = torch.cat([torch.arange(b) + b, torch.arange(b)]).to(z.device)
    logp = torch.log_softmax(sim, dim=-1)
    return -logp[torch.arange(n, device=z.device), pos].mean()


def simclr_schedule(peak_lr: float, warmup_steps: int, total_steps: int,
                    end_value: float = END_LR) -> Callable[[int], float]:
    """optax ``warmup_cosine_decay_schedule(init_value=peak / 3, peak,
    warmup_steps, decay_steps=total_steps, end_value)``: linear from
    peak / 3 to the peak over the warmup, then a cosine to ``end_value``
    at ``total_steps``."""
    init = peak_lr / 3
    alpha = 0.0 if peak_lr == 0.0 else end_value / peak_lr
    decay = total_steps - warmup_steps
    if decay <= 0:
        raise ValueError(f"the cosine needs total_steps > warmup_steps, "
                         f"got {total_steps} and {warmup_steps}")

    def schedule(step: int) -> float:
        if step < warmup_steps:
            frac = 1.0 - max(step, 0) / warmup_steps
            return (init - peak_lr) * frac + peak_lr
        t = min(step - warmup_steps, decay)
        cos = 0.5 * (1.0 + math.cos(math.pi * t / decay))
        return peak_lr * ((1.0 - alpha) * cos + alpha)

    return schedule


def make_simclr_train_step(schedule: Callable[[int], float],
                           temperature: float = 0.5) -> Callable:
    """``train_step(state, view1, view2, seed) -> metrics`` on a
    SimCLRNet's ``TrainState`` (no EMA), in place.  ``lr`` in the metrics
    is ``schedule(state.step)`` before the step, as JAX logs it; the
    update itself takes ``schedule`` at the optimizer's count.  The two
    differ after ``cli.pretrain_simclr --init-from``, which restarts the
    step but keeps the count, as JAX does (ROADMAP.md, the known defects
    of the JAX reference)."""

    def train_step(state: TrainState, view1: torch.Tensor,
                   view2: torch.Tensor, seed: int) -> Dict:
        model = state.model
        images = torch.cat([view1, view2], dim=0)
        s = step_seed(seed, state.step)
        model.train()
        z, bank = model(images, train=True, bank_count=state.bank_count,
                        rng=DropoutRng(s >> 2, images.device))
        loss = nt_xent_loss(z, temperature)
        params = state.params()
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, params)]
        grad_norm = global_norm(grads)
        # optax clip_by_global_norm: g unchanged below the limit, else
        # g / norm * limit
        scale = torch.where(grad_norm < MAX_GRAD_NORM, 1.0,
                            MAX_GRAD_NORM / grad_norm)
        grads = [(g * scale).to(g.dtype) for g in grads]
        swap_bank(model, bank)
        lr_logged = schedule(state.step)
        adamw_update(params, grads, state.opt, [True] * len(params),
                     schedule(state.opt.count), WEIGHT_DECAY)
        state.step += 1
        state.bank_count = bank.count.detach()
        return {"loss": loss.detach(), "grad_norm": grad_norm.detach(),
                "lr": lr_logged}

    return train_step


def extract_backbone_params(params: Dict[str, torch.Tensor]
                            ) -> Dict[str, torch.Tensor]:
    """The backbone's entries of a SimCLRNet's parameters (or buffers),
    renamed as the supervised model names them; the projection head is
    left out.  Raises KeyError without a backbone scope, as JAX's
    ``extract_backbone_params`` does."""
    tops = sorted({n.split(".", 1)[0] for n in params})
    scope = next((s for s in ("HQAViT_0", "QAViT_0") if s in tops), None)
    if scope is None:
        raise KeyError(f"no backbone scope in {tops}")
    return {n[len(scope) + 1:]: v for n, v in params.items()
            if n.startswith(scope + ".")}
