"""Test-time augmentation: the reference's five views
(HQAViT_C100_Finetune.py:106-132; counterpart of ``qavit_tpu/eval/tta.py``)

    0. identity (ToTensor + Normalize)
    1. RandomHorizontalFlip(p=1.0)            -> the flip
    2. RandomCrop(size, padding=2)            -> random offsets per image
    3. HFlip(p=1.0), then RandomCrop(size, 2) -> flip first (Compose order)
    4. ColorJitter(brightness=0.1)            -> factor ~ U[0.9, 1.1] per image

The views run on the images' device.  Drawing is apart from applying, as
in ``data/augment.py``: :func:`draw_view_params` draws a view's per-image
parameters from a ``torch.Generator``, :func:`apply_view` is
deterministic in the images and the parameters (so a test can feed in
the JAX package's draws).  :func:`make_tta_preprocessors` re-seeds a
generator per view and batch from (seed, view, batch), as JAX folds the
view and a batch counter into its key (``tta.py:62-69``), so every batch
gets fresh draws and a rerun gets the same ones.  The probabilities of
the five views are summed in ``eval/metrics.py`` ``validate_tta``.
"""

from __future__ import annotations

import itertools
from typing import Callable, List

import torch

from qavit_tpu_torch.data import augment as A
from qavit_tpu_torch.train.steps import step_seed

VIEWS = ("identity", "flip", "crop", "flip_crop", "brightness")
CROP_PAD = 2
BRIGHTNESS = 0.1


def view_seed(seed: int, view: int, batch: int) -> int:
    """The generator seed of one view of one batch."""
    return step_seed(step_seed(seed, view) & 0xFFFFFFFF, batch) & (
        2 ** 63 - 1)


def draw_view_params(view: int, n: int, generator: torch.Generator
                     ) -> A.Params:
    """The per-image parameters of view ``view`` for ``n`` images, on
    the generator's device."""
    dev = generator.device
    name = VIEWS[view]
    if name in ("crop", "flip_crop"):
        hi = 2 * CROP_PAD + 1
        return {"crop_y": torch.randint(0, hi, (n,), generator=generator,
                                        device=dev),
                "crop_x": torch.randint(0, hi, (n,), generator=generator,
                                        device=dev)}
    if name == "brightness":
        u = torch.rand(n, generator=generator, device=dev)
        return {"brightness": (1 - BRIGHTNESS) + 2 * BRIGHTNESS * u}
    return {}


def apply_view(view: int, images_u8: torch.Tensor, params: A.Params,
               aug: A.AugConfig) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> view ``view`` of the images, normalised with
    ``aug``'s statistics (float32)."""
    name = VIEWS[view]
    img = images_u8.float()
    if name in ("flip", "flip_crop"):
        img = img.flip(2)
    if name in ("crop", "flip_crop"):
        img = A.crop(img, params["crop_y"], params["crop_x"], CROP_PAD)
    if name == "brightness":
        f = params["brightness"].float()[:, None, None, None]
        img = torch.clamp(img * f, 0.0, 255.0)
    return A.normalize(img * (1.0 / 255.0), aug.mean, aug.std)


def make_tta_preprocessors(aug: A.AugConfig, seed: int = 0
                           ) -> List[Callable]:
    """The five view preprocessors: each maps a uint8 batch to its
    normalised view, with fresh draws for each batch it is given."""

    def preprocessor(view: int) -> Callable:
        counter = itertools.count()

        def prep(images_u8: torch.Tensor) -> torch.Tensor:
            gen = torch.Generator(device=images_u8.device).manual_seed(
                view_seed(seed, view, next(counter)))
            params = draw_view_params(view, images_u8.shape[0], gen)
            return apply_view(view, images_u8, params, aug)

        return prep

    return [preprocessor(v) for v in range(len(VIEWS))]
