"""Flattened-parameter AdamW: the whole update as a handful of vector ops
(counterpart of ``qavit_tpu/train/flat_optim.py``).

The same math as the per-tensor chain (``train/optim.py``), on one raveled
float32 vector of every parameter in ``TrainState.names`` order
(``flat_optim.py:78-127``):

1. the subtree pre-clip of the ``subtree_clip_keys`` leaves, each JAX leaf
   (a stack's blocks merged, ``optim._groups``) by its own norm;
2. one global-norm reduction over the raveled gradients and the clip;
3. Adam's moments as two ``[P]`` vectors, with the bias correction;
4. decoupled weight decay through the ``NO_WD_KEYS`` mask, folded into a
   ``[P]`` vector;
5. the LR-group multipliers as a ``[P]`` vector;
6. ``-schedule(count)``;
7. ``param_norm = ||p + u||`` and the pre-clip ``grad_norm`` kept in the
   state for the step's metrics.

A step is one ``torch.cat`` of the gradients and one of the parameters,
the vector ops, and one split of the update back into the parameters
(``torch._foreach_add_``); the EMA is one fused multiply-add on a flat
buffer whose views are ``TrainState.ema_params`` (:func:`flat_ema_update`).
As in JAX the parameters must all be float32 (bf16 is compute only).  The
state's layout is fixed by the parameters' sizes and order, so a
checkpoint of it restores only into a flat state
(``ckpt/checkpoint.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import torch

from qavit_tpu_torch.configs.training import TrainingConfig
from qavit_tpu_torch.train.optim import (_groups, decays,
                                         tensor_multipliers)

B1, B2, EPS = 0.9, 0.999, 1e-8


@dataclass
class FlatAdamState:
    """JAX's ``FlatAdamWState``: the update count, the raveled moments and
    the last step's norms (float32 device scalars)."""

    count: int
    mu: torch.Tensor
    nu: torch.Tensor
    grad_norm: torch.Tensor
    param_norm: torch.Tensor

    def split(self, vec: torch.Tensor, params: Sequence[torch.Tensor]
              ) -> List[torch.Tensor]:
        """Views of a raveled vector laid out like ``params``."""
        return [v.view_as(p) for v, p in
                zip(vec.split([p.numel() for p in params]), params)]


def check_float32(params: Sequence[torch.Tensor]) -> None:
    bad = sorted({str(p.dtype) for p in params} - {"torch.float32"})
    if bad:
        raise TypeError(f"the flat optimizer needs float32 parameters, "
                        f"got {bad} (bf16 is compute only)")


def flat_adam_init(params: Sequence[torch.Tensor]) -> FlatAdamState:
    check_float32(params)
    n = sum(p.numel() for p in params)
    dev = params[0].device
    z = lambda: torch.zeros((), dtype=torch.float32, device=dev)  # noqa
    return FlatAdamState(0, torch.zeros(n, device=dev),
                         torch.zeros(n, device=dev), z(), z())


def flat_buffer(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """One float32 buffer holding ``tensors`` in order; the caller takes
    its views (``FlatAdamState.split``)."""
    return torch.cat([t.detach().reshape(-1).float() for t in tensors])


class FlatAdamW:
    """The layout of one parameter list: sizes, the weight-decay and
    LR-group vectors and the pre-clip groups, built once."""

    def __init__(self, names: Sequence[str],
                 params: Sequence[torch.Tensor], tc: TrainingConfig):
        check_float32(params)
        self.tc = tc
        dev = params[0].device
        self.sizes = [p.numel() for p in params]
        self.numel = sum(self.sizes)
        per = lambda vals: torch.cat([                       # noqa: E731
            torch.full((s,), float(v)) for s, v in zip(self.sizes, vals)
        ]).to(dev) if self.numel else torch.zeros(0, device=dev)
        self.wd = per([tc.weight_decay if decays(n) else 0.0
                       for n in names])
        mults = tensor_multipliers(names, tc)
        self.mult = None if mults is None else per(mults)
        # pre-clip: the member tensors of each clipped JAX leaf, padded
        # with an index to a zero so the leaf sums are one gather
        self.clip_idx: List[int] = []
        self.clip_rows: Optional[torch.Tensor] = None
        if tc.subtree_clip_norm is not None:
            leaves = [idx for path, idx in _groups(names).items()
                      if any(k in path for k in tc.subtree_clip_keys)]
            self.clip_idx = [i for idx in leaves for i in idx]
            width = max((len(idx) for idx in leaves), default=0)
            rows, pos = [], 0
            for idx in leaves:
                rows.append(list(range(pos, pos + len(idx)))
                            + [len(self.clip_idx)] * (width - len(idx)))
                pos += len(idx)
            self.clip_rows = torch.tensor(rows, dtype=torch.long,
                                          device=dev)
            self.clip_leaf = torch.tensor(
                [r for r, idx in enumerate(leaves) for _ in idx],
                dtype=torch.long, device=dev)

    def _pre_clip(self, grads: List[torch.Tensor]) -> None:
        if not self.clip_idx:
            return
        sub = [grads[i] for i in self.clip_idx]
        sq = torch.stack(torch._foreach_norm(sub)).float().square()
        sq = torch.cat([sq, sq.new_zeros(1)])
        norm = sq[self.clip_rows].sum(1).sqrt()
        scale = torch.clamp(self.tc.subtree_clip_norm / (norm + 1e-6),
                            max=1.0)[self.clip_leaf]
        torch._foreach_mul_(sub, list(scale.unbind()))

    @torch.no_grad()
    def update(self, params: Sequence[torch.Tensor],
               grads: Sequence[torch.Tensor], state: FlatAdamState,
               lr: float) -> torch.Tensor:
        """One step in place on ``params`` and ``state``; returns the new
        parameters raveled (for the EMA)."""
        tc = self.tc
        grads = list(grads)
        self._pre_clip(grads)
        g = torch.cat([x.reshape(-1) for x in grads]).float()
        grad_norm = g.square().sum().sqrt()
        if tc.grad_clip_mode == "norm":
            g.mul_(torch.clamp(tc.max_grad_norm / (grad_norm + 1e-6),
                               max=1.0))
        elif tc.grad_clip_mode == "value":
            g.clamp_(-tc.max_grad_norm, tc.max_grad_norm)
        state.count += 1
        state.mu.lerp_(g, 1 - B1)
        state.nu.mul_(B2).addcmul_(g, g, value=1 - B2)
        c1, c2 = 1 - B1 ** state.count, 1 - B2 ** state.count
        u = (state.mu / c1).div_((state.nu / c2).sqrt_().add_(EPS))
        p = torch.cat([x.detach().reshape(-1) for x in params])
        u.addcmul_(p, self.wd)
        if self.mult is not None:
            u.mul_(self.mult)
        u.mul_(-lr)
        torch._foreach_add_(list(params), state.split(u, params))
        p.add_(u)
        state.grad_norm = grad_norm
        state.param_norm = p.square().sum().sqrt()
        return p


@torch.no_grad()
def flat_ema_update(ema: torch.Tensor, params: torch.Tensor,
                    decay: float) -> None:
    """The EMA as one fused multiply-add on the raveled vectors."""
    ema.mul_(decay).add_(params, alpha=1.0 - decay)
