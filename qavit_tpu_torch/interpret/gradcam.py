"""Grad-CAM on the patch-embedding activations (counterpart of
``qavit_tpu/interpret/gradcam.py``; the reference's ``test_hqa.py:229-354``).

The reference forward-hooks ``model.patch_embed.proj``, the projection
before the embedding LayerNorm.  The port's ``PatchEmbed`` adds a zero
perturbation ``[1, N, C]`` at that point (``patch_perturb`` of the
models' forward), so the gradient of the score with respect to it is the
hook's gradient, and ``PatchEmbed(..., pre_norm=True)`` in float32 is the
hooked activation.  On the card the gradient flows back through the
fused units' eval-mode backward kernels (``kernels/fused_kernels.py``
``_EvalUnit``) and, at 224, through the flash kernel's autograd Function.

cam = ReLU(sum_c mean_grad_c * act_c), min-max normalised, bilinearly
upsampled as ``jax.image.resize`` (``nn/resize.py``); the batch loop
writes ``gradcam_{idx}_pred{p}_true{t}_{heat,overlay}.png``, the jet
heatmap and its 0.5-alpha overlay (``interpret/png.py``: no matplotlib
or PIL needed).
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

from qavit_tpu_torch.interpret.png import heat_and_overlay, write_png
from qavit_tpu_torch.nn.models import compute_dtype
from qavit_tpu_torch.nn.resize import resize


def _device(model) -> torch.device:
    return next(model.parameters()).device


def _image(image, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(image) if not isinstance(
        image, torch.Tensor) else image, dtype=torch.float32).to(device)


def upsample_map(m: torch.Tensor, n: int, hw: Tuple[int, int]) -> np.ndarray:
    """A map over the n patch tokens, min-max normalised on its square
    grid and resized to ``hw`` (bilinear, ``jax.image.resize``'s)."""
    g = math.isqrt(n)
    m = m.float().reshape(g, g)
    m = m - m.min()
    m = m / (m.max() + 1e-8)
    out = resize(m[None, :, :, None], (1, hw[0], hw[1], 1), "bilinear")
    return out[0, :, :, 0].cpu().numpy()


def grad_cam(model, image, class_idx: Optional[int] = None,
             bank_count=0) -> Tuple[np.ndarray, int]:
    """A Grad-CAM heatmap for one image.

    Args:
      image: [H, W, 3] normalised float input (numpy or a tensor).
    Returns:
      (cam [H, W] float in [0, 1], predicted-or-requested class index)
    """
    cfg = model.cfg
    dev = _device(model)
    x = _image(image, dev)[None]
    pert = torch.zeros(1, cfg.num_patches, cfg.embed_dim,
                       dtype=compute_dtype(cfg), device=dev,
                       requires_grad=True)
    with torch.enable_grad():
        logits, _ = model(x, bank_count=bank_count, patch_perturb=pert)
        cls = int(class_idx if class_idx is not None
                  else logits[0].argmax().item())
        grads, = torch.autograd.grad(logits[0, cls], pert)
    with torch.no_grad():
        acts = model.patch_embed(x, torch.float32, pre_norm=True)
        weights = grads.float()[0].mean(dim=0)                 # [C]
        cam = torch.relu((acts[0] * weights).sum(dim=-1))      # [N]
    return upsample_map(cam, cfg.num_patches, tuple(x.shape[1:3])), cls


def save_gradcam_overlay(cam: np.ndarray, image_u8: np.ndarray,
                         out_prefix: str) -> Tuple[str, str]:
    """Jet-colormap heatmap + 0.5-alpha overlay PNGs
    (``test_hqa.py:281-318``)."""
    heat, overlay = heat_and_overlay(cam, np.asarray(image_u8))
    heat_path = f"{out_prefix}_heat.png"
    over_path = f"{out_prefix}_overlay.png"
    write_png(heat_path, heat)
    write_png(over_path, overlay)
    return heat_path, over_path


def gradcam_on_batch(model, images_norm, images_u8, labels, out_dir: str,
                     max_images: int = 30, bank_count=0) -> List:
    """The batch loop of gradcam_on_loader (``test_hqa.py:322-354``):
    one image at a time."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    written = []
    for idx in range(min(len(images_norm), max_images)):
        cam, pred = grad_cam(model, images_norm[idx], bank_count=bank_count)
        true = int(labels[idx])
        prefix = out / f"gradcam_{idx}_pred{pred}_true{true}"
        written.append(save_gradcam_overlay(cam, np.asarray(images_u8[idx]),
                                            str(prefix)))
    return written
