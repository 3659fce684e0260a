"""Attention dispatch: the plain path and the flash kernel
(counterpart of ``qavit_tpu/kernels/attention.py``).

Layout ``[B, N, H, D]`` (heads after tokens), as in the JAX package.
:func:`attention` picks the path per call as ``attention.py:93-131``
does: ``auto`` takes the hand-written kernel
(:mod:`qavit_tpu_torch.kernels.flash_attention`) on the card for
n_q >= 128 and head_dim >= 32, and the plain path otherwise and whenever
it trains with dropout; ``pallas`` (the name configs carry) asks for the
kernel, which on the CPU runs its plain version; ``xla`` the plain path.

Dropout draws from a counter hash salted by ``rng`` (an int), not from
``jax.random``: the plain path and the kernel then use the same mask,
and neither uses JAX's (ROADMAP queue 3 lists the difference).
"""

from __future__ import annotations

from typing import Optional

import torch

from qavit_tpu_torch.kernels import flash_attention as FA

# below these the JAX package keeps XLA (``attention.py:48-60``)
MIN_HEAD_DIM = 32
MIN_NQ = 128


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  dropout_rate: float = 0.0, deterministic: bool = True,
                  rng: Optional[int] = None) -> torch.Tensor:
    """Scaled dot-product attention, float32 scores (times the float32
    1/sqrt(D)) and softmax, dropout, probabilities cast to v's dtype,
    PV in float32, output in q's dtype (``attention.py:25-45``)."""
    if dropout_rate > 0.0 and not deterministic:
        return FA.plain(q, k, v, dropout_rate, _salt(rng))
    return FA.plain(q, k, v)


def use_flash(q_shape, device) -> bool:
    """The ``use_pallas`` gate (``attention.py:50-60``) with the card in
    place of the TPU."""
    if torch.device(device).type != "cuda":
        return False
    _, n_q, _, d = q_shape
    return d >= MIN_HEAD_DIM and n_q >= MIN_NQ


def _salt(rng: Optional[int]) -> int:
    if rng is None:
        raise ValueError("attention dropout in training needs rng, an int")
    return int(rng)


class _FlashAttention(torch.autograd.Function):
    """The kernel's forward with a recompute backward: autograd through
    :func:`xla_attention` (``_pallas_attention``, ``attention.py:63-90``;
    its backward is XLA there too)."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return FA.flash_attention(q, k, v)

    @staticmethod
    def backward(ctx, ct):
        leaves = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = xla_attention(*leaves)
        return torch.autograd.grad(out, leaves, ct)


class _FlashDropout(torch.autograd.Function):
    """An explicit ``pallas`` request with train dropout: forward only
    (``attention.py:120-130``)."""

    @staticmethod
    def forward(ctx, q, k, v, rate, salt):
        return FA.flash_attention(q, k, v, rate, salt)

    @staticmethod
    def backward(ctx, ct):
        raise RuntimeError("attention impl='pallas' with train dropout is "
                           "forward-only; train with impl='auto' or 'xla'")


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              dropout_rate: float = 0.0, deterministic: bool = True,
              rng: Optional[int] = None, impl: str = "auto") -> torch.Tensor:
    """q [B, Nq, H, D], k and v [B, Nkv, H, D] -> [B, Nq, H, D] in q's
    dtype; ``impl`` is "auto" | "xla" | "pallas" (or "fused_block", a
    block-level choice that means "auto" here)."""
    train_dropout = dropout_rate > 0.0 and not deterministic
    if impl == "fused_block":
        impl = "auto"
    if impl == "auto":
        impl = ("pallas" if use_flash(q.shape, q.device) and not train_dropout
                else "xla")
    if impl == "xla":
        return xla_attention(q, k, v, dropout_rate, deterministic, rng)
    if impl != "pallas":
        raise ValueError(f"unknown attention impl {impl!r}; "
                         "expected auto | xla | pallas")
    if train_dropout:
        return _FlashDropout.apply(q, k, v, dropout_rate, _salt(rng))
    return _FlashAttention.apply(q, k, v)
