"""Image resize as ``jax.image.resize`` computes it (counterpart of the
calls at ``qavit_tpu/nn/hybrid.py:177``, bilinear, and
``qavit_tpu/nn/layers.py:241``, bicubic).

``jax.image.resize`` is a separable resampling: for each spatial axis a
weight matrix ``[in, out]`` (``jax/_src/image/scale.py``
``compute_weight_mat``) contracted with the image.  It widens the kernel
by 1 / scale when it downsamples (antialias), renormalises each output's
weights over the taps that fall inside the input and zeroes an output
whose sample lies outside it.

Bilinear: ``F.interpolate`` with half-pixel centres, antialiased when an
axis shrinks, computes the same triangle weights with the same
renormalisation at the borders, so it is used as it is (the augmentation's
resize is this one too).  Bicubic: JAX's cubic is Keys' with a = -0.5,
where ``F.interpolate``'s is a = -0.75 with clamped indices, so the port
builds JAX's matrices and applies them as one matmul per axis in float32.
An input of another dtype is resampled in float32 and the result rounded
back to it; the bicubic weights are first rounded to that dtype, as JAX
casts them to the image's dtype.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

_EPS32 = float(np.finfo(np.float32).eps)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def weight_matrix(in_size: int, out_size: int) -> np.ndarray:
    """The float32 ``[in_size, out_size]`` bicubic matrix of one axis,
    computed in float32 as ``compute_weight_mat`` computes it (scale
    out / in, no translation, antialias)."""
    f32 = np.float32
    # JAX takes 1 / scale in double precision, then works in float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = ((np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale
              - f32(0.5))
    x = (np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None])
         / kernel_scale).astype(f32)
    w = _keys_cubic(x).astype(f32)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * _EPS32,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def _bilinear(x: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    b, h, w, c = x.shape
    if (shape[0], shape[3]) != (b, c):
        raise ValueError(f"bilinear resizes [B, H, W, C] over H and W: "
                         f"{tuple(x.shape)} -> {tuple(shape)}")
    if (shape[1], shape[2]) == (h, w):
        return x
    y = F.interpolate(x.float().permute(0, 3, 1, 2), size=tuple(shape[1:3]),
                      mode="bilinear", align_corners=False,
                      antialias=shape[1] < h or shape[2] < w)
    return y.permute(0, 2, 3, 1).contiguous().to(x.dtype)


def _bicubic(x: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    dtype = x.dtype
    y = x.float()
    for axis, (m, n) in enumerate(zip(x.shape, shape)):
        if m == n:
            continue
        w = torch.from_numpy(weight_matrix(m, n))
        w = w.to(device=x.device, dtype=dtype).float()
        y = torch.movedim(torch.tensordot(y, w, dims=([axis], [0])), -1,
                          axis)
    return y.to(dtype)


def resize(x: torch.Tensor, shape: Sequence[int], method: str
           ) -> torch.Tensor:
    """``jax.image.resize(x, shape, method)`` for the two methods the JAX
    package calls: "bilinear" on a ``[B, H, W, C]`` map (H and W
    resampled), "bicubic" on any shape (every axis whose size changes
    resampled, in axis order)."""
    if len(shape) != x.dim():
        raise ValueError(f"shape {tuple(shape)} for an input of "
                         f"{x.dim()} dimensions")
    if method == "bilinear":
        return _bilinear(x, shape)
    if method == "bicubic":
        return _bicubic(x, shape)
    raise ValueError(f"unknown resize method {method!r}")
