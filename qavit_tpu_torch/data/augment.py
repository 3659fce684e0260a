"""Train-time augmentation and eval preprocessing on the device (the
port's counterpart of ``qavit_tpu/data/augment.py``).

The raw uint8 batch [B, H, W, 3] stays on its device and every op works
on the whole batch at once with per-image parameters: no loop over the
images, and the number of launches does not depend on B.  Drawing is
apart from applying:

* :func:`draw_params` draws every per-image parameter from an explicit
  ``torch.Generator`` on the images' device (tensors of leading dim B);
* :func:`apply_augment` is deterministic in the images and parameters;
* :func:`augment_batch` is the two together.

The ops equal the JAX package's for the same parameters (the tests hold
each one to it); the draws follow the distributions of its
``augment_image`` (ranges, probabilities, magnitudes), not its streams:
torch cannot replay ``jax.random``.  The order is ``augment_image``'s:
resize, random-resized-crop or zero-padded crop, hflip, rotation, colour
jitter (brightness, contrast, saturation, hue under one Bernoulli),
RandAugment, blur, normalize, random erasing (on the normalised image,
N(0, 1) noise).

The resamplers are the JAX package's weights ``relu(1 - |src - u|)``
with zero fill, written as two-tap gathers (the only taps with nonzero
weight) in float32, so no TF32 setting reaches them.  Per-image scalars
that go through a transcendental function or a reduction (rotation
shears, crop and erasing boxes, blur kernels, contrast means) are
computed in float64 and rounded once, so the card and the CPU give the
same parameters to the pixel ops; the pixel ops are single float32
roundings each, and none divides by a Python number (the card multiplies
by its float32 reciprocal where the CPU divides, an ulp apart, which a
later posterize or equalize can turn into a whole level).  The erasing
noise comes from a counter hash of a per-image seed (Box-Muller), so it
too is fixed by the parameters.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from qavit_tpu_torch.kernels.fused_ref import fmix32
from qavit_tpu_torch.nn.resize import resize as jax_resize

Params = Dict[str, torch.Tensor]

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B1
RANDAUG_OPS = 14


@dataclass(frozen=True)
class AugConfig:
    mean: Tuple[float, float, float]
    std: Tuple[float, float, float]
    # Resize(resize_to) before everything else (QAViT.py:714: Resize 224)
    resize_to: Optional[int] = None
    crop_pad: int = 4                      # RandomCrop(size, padding)
    hflip: bool = True
    rotation_deg: float = 0.0              # RandomRotation(degrees)
    jitter: Optional[Tuple[float, float, float, float]] = None  # b,c,s,h
    jitter_prob: float = 1.0
    randaug_ops: int = 0
    randaug_magnitude: int = 0
    erasing_prob: float = 0.0
    erasing_scale: Tuple[float, float] = (0.02, 0.33)
    erasing_ratio: Tuple[float, float] = (0.3, 3.3)
    # RandomApply(GaussianBlur(kernel, sigma=(0.1, 2))), the STL pipeline
    blur_prob: float = 0.0
    blur_kernel: int = 3
    # RandomResizedCrop for STL/SimCLR (scale range); None = plain crop
    rrc_scale: Optional[Tuple[float, float]] = None

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def _per_image(x: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
    """A [B] parameter shaped to broadcast over [B, H, W, C]."""
    return x.reshape(-1, *([1] * (img.dim() - 1)))


# ---------------------------------------------------------------------------
# geometry (img: [B, H, W, C] float32)
# ---------------------------------------------------------------------------

def _resample(img: torch.Tensor, src: torch.Tensor, axis: int
              ) -> torch.Tensor:
    """Resample along ``axis`` (2: x, 1: y) at per-output source
    coordinates ``src`` [B, H, W]: ``out = sum_u relu(1 - |src - u|) *
    img[u]`` over the pixels u of the line, zero outside the image."""
    n, c = img.shape[axis], img.shape[-1]
    u0 = torch.floor(src)
    out = None
    for u in (u0, u0 + 1.0):
        w = torch.clamp(1.0 - torch.abs(src - u), min=0.0)
        w = torch.where((u >= 0.0) & (u <= n - 1.0), w, 0.0)
        idx = u.clamp(0.0, n - 1.0).long()[..., None].expand(-1, -1, -1, c)
        term = w[..., None] * torch.gather(img, axis, idx)
        out = term if out is None else out + term
    return out


def _grid(img: torch.Tensor):
    """Centred pixel coordinates ``(gy, gx)``, each [H, W]."""
    h, w = img.shape[1], img.shape[2]
    yy = torch.arange(h, dtype=torch.float32, device=img.device)
    xx = torch.arange(w, dtype=torch.float32, device=img.device)
    return torch.meshgrid(yy - (h - 1) / 2.0, xx - (w - 1) / 2.0,
                          indexing="ij")


def shear_x(img: torch.Tensor, mag: torch.Tensor) -> torch.Tensor:
    """out(y, x) <- in(y, x + mag*y) around the centre; mag [B]."""
    gy, gx = _grid(img)
    m = mag.float()[:, None, None]
    return _resample(img, gx + m * gy + (img.shape[2] - 1) / 2, 2)


def shear_y(img: torch.Tensor, mag: torch.Tensor) -> torch.Tensor:
    gy, gx = _grid(img)
    m = mag.float()[:, None, None]
    return _resample(img, gy + m * gx + (img.shape[1] - 1) / 2, 1)


def translate_x(img: torch.Tensor, pixels: torch.Tensor) -> torch.Tensor:
    gy, gx = _grid(img)
    return _resample(img, gx + pixels.float()[:, None, None]
                     + (img.shape[2] - 1) / 2, 2)


def translate_y(img: torch.Tensor, pixels: torch.Tensor) -> torch.Tensor:
    gy, gx = _grid(img)
    return _resample(img, gy + pixels.float()[:, None, None]
                     + (img.shape[1] - 1) / 2, 1)


def rotate(img: torch.Tensor, deg: torch.Tensor) -> torch.Tensor:
    """Paeth three-shear rotation by ``deg`` [B] degrees: Sx(a) Sy(b)
    Sx(a) with a = tan(t/2), b = -sin(t), each pass a separable
    resample (the JAX package's rotation, not a direct bilinear one)."""
    rad = deg.double() * (math.pi / 180.0)
    a = torch.tan(rad / 2.0).float()
    b = (-torch.sin(rad)).float()
    return shear_x(shear_y(shear_x(img, a), b), a)


def crop(img: torch.Tensor, oy: torch.Tensor, ox: torch.Tensor, pad: int
         ) -> torch.Tensor:
    """RandomCrop(size, padding=pad) with zero padding at offsets
    ``oy``, ``ox`` [B] in 0..2 pad of the padded image."""
    b, h, w, _ = img.shape
    sy = torch.arange(h, device=img.device) + (oy[:, None] - pad)   # [B, H]
    sx = torch.arange(w, device=img.device) + (ox[:, None] - pad)   # [B, W]
    valid = (((sy >= 0) & (sy < h))[:, :, None]
             & ((sx >= 0) & (sx < w))[:, None, :])
    bi = torch.arange(b, device=img.device)[:, None, None]
    out = img[bi, sy.clamp(0, h - 1)[:, :, None], sx.clamp(0, w - 1)[:, None]]
    return torch.where(valid[..., None], out, 0.0)


def resized_crop(img: torch.Tensor, area: torch.Tensor,
                 log_ratio: torch.Tensor, uy: torch.Tensor,
                 ux: torch.Tensor) -> torch.Tensor:
    """RandomResizedCrop back to the same size: the crop's area fraction
    ``area``, log aspect ``log_ratio`` and placement ``uy``, ``ux`` in
    [0, 1) of the free range, each [B]; scale and translate as two
    separable resamples."""
    h, w = img.shape[1], img.shape[2]
    ratio = torch.exp(log_ratio.double())
    ch = (torch.sqrt(area.double() / ratio) * h).clamp(1.0, h)
    cw = (torch.sqrt(area.double() * ratio) * w).clamp(1.0, w)
    oy = uy.double() * (h - ch)
    ox = ux.double() * (w - cw)
    gy, gx = _grid(img)
    sx, tx = (cw * (1.0 / w)).float(), (ox + (cw - 1) * 0.5).float()
    sy, ty = (ch * (1.0 / h)).float(), (oy + (ch - 1) * 0.5).float()
    img = _resample(img, sx[:, None, None] * gx + tx[:, None, None], 2)
    return _resample(img, sy[:, None, None] * gy + ty[:, None, None], 1)


def hflip(img: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    return torch.where(_per_image(flip, img), img.flip(2), img)


# ---------------------------------------------------------------------------
# photometric ops (inputs in [0, 255] float)
# ---------------------------------------------------------------------------

def _blend(a: torch.Tensor, b: torch.Tensor, factor: torch.Tensor
           ) -> torch.Tensor:
    return torch.clamp(b + _per_image(factor.float(), a) * (a - b),
                       0.0, 255.0)


def _grayscale(img: torch.Tensor) -> torch.Tensor:
    return (0.299 * img[..., 0] + 0.587 * img[..., 1]
            + 0.114 * img[..., 2])[..., None]


def adjust_brightness(img: torch.Tensor, factor: torch.Tensor
                      ) -> torch.Tensor:
    return _blend(img, torch.zeros_like(img), factor)


def adjust_contrast(img: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    mean = _grayscale(img).double().mean(dim=(1, 2, 3), keepdim=True)
    return _blend(img, mean.float().expand_as(img), factor)


def adjust_saturation(img: torch.Tensor, factor: torch.Tensor
                      ) -> torch.Tensor:
    return _blend(img, _grayscale(img).expand_as(img), factor)


def adjust_hue(img: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Hue rotation by ``delta`` [B] (fraction of the colour wheel)."""
    x = img * (1.0 / 255.0)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    mx = torch.amax(x, dim=-1)
    mn = torch.amin(x, dim=-1)
    diff = mx - mn + 1e-8
    h = torch.where(
        mx == r, (g - b) / diff,
        torch.where(mx == g, 2.0 + (b - r) / diff, 4.0 + (r - g) / diff))
    h = torch.remainder(h * (1.0 / 6.0), 1.0)
    s = torch.where(mx > 0, diff / (mx + 1e-8), 0.0)
    v = mx
    h = torch.remainder(h + delta.float()[:, None, None], 1.0)
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    i = torch.remainder(i.long(), 6)[..., None]

    def pick(*opts):
        return torch.stack(opts, dim=-1).gather(-1, i)[..., 0]

    rgb = torch.stack([pick(v, q, p, p, t, v), pick(t, v, v, q, p, p),
                       pick(p, p, t, v, v, q)], dim=-1)
    return torch.clamp(rgb * 255.0, 0.0, 255.0)


def autocontrast(img: torch.Tensor) -> torch.Tensor:
    lo = torch.amin(img, dim=(1, 2), keepdim=True)
    hi = torch.amax(img, dim=(1, 2), keepdim=True)
    scale = torch.where(hi > lo, 255.0 / (hi - lo), 1.0)
    offs = torch.where(hi > lo, -lo * scale, 0.0)
    return torch.clamp(img * scale + offs, 0.0, 255.0)


def equalize(img: torch.Tensor) -> torch.Tensor:
    """PIL-style histogram equalization per image and channel (uint8
    semantics): 256-bin histograms of all B x C channels at once, the
    torchvision ``step`` and LUT rule, the LUT gathered back."""
    b, h, w, c = img.shape
    v = torch.clamp(img, 0, 255).long()
    chan = (torch.arange(b, device=img.device)[:, None] * c
            + torch.arange(c, device=img.device))[:, None, None, :]
    key = chan * 256 + v                                    # [B, H, W, C]
    hist = torch.zeros(b * c * 256, dtype=torch.long, device=img.device)
    hist.scatter_add_(0, key.reshape(-1), torch.ones_like(key.reshape(-1)))
    hist = hist.view(b * c, 256)
    last = 255 - torch.argmax((hist > 0).flip(-1).int(), dim=-1)
    step = (hist.sum(-1) - hist.gather(-1, last[:, None])[:, 0]) // 255
    lut = ((hist.cumsum(-1) + (step // 2)[:, None])
           // step.clamp(min=1)[:, None])
    lut = torch.cat([torch.zeros_like(lut[:, :1]), lut[:, :-1]], dim=-1)
    out = lut.clamp(0, 255).float().reshape(-1)[key]
    return torch.where((step == 0).view(b, 1, 1, c), img, out)


def posterize(img: torch.Tensor, bits: int) -> torch.Tensor:
    mask = (0xFF << (8 - bits)) & 0xFF
    return (img.int() & mask).float()


def solarize(img: torch.Tensor, threshold: float) -> torch.Tensor:
    return torch.where(img >= threshold, 255.0 - img, img)


def _taps(img: torch.Tensor, radius: int, axis: int):
    """The 2 radius + 1 shifted copies of ``img`` along ``axis`` (1: y,
    2: x), zero outside the image: entry t is img at offset t - radius."""
    pad = [0, 0, 0, 0, 0, 0]
    pad[2 * (3 - axis)] = pad[2 * (3 - axis) + 1] = radius
    p = F.pad(img, pad)
    n = img.shape[axis]
    return [p.narrow(axis, t, n) for t in range(2 * radius + 1)]


def sharpness(img: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """Blend with the [[1,1,1],[1,5,1],[1,1,1]]/13 blur, the border
    pixels kept (PIL)."""
    kern = [[1.0 / 13.0] * 3, [1.0 / 13.0, 5.0 / 13.0, 1.0 / 13.0],
            [1.0 / 13.0] * 3]
    blurred = None
    for dy, row in enumerate(_taps(img, 1, 1)):
        for dx, tap in enumerate(_taps(row, 1, 2)):
            term = tap * kern[dy][dx]
            blurred = term if blurred is None else blurred + term
    h, w = img.shape[1], img.shape[2]
    yy = torch.arange(h, device=img.device)[:, None]
    xx = torch.arange(w, device=img.device)[None, :]
    border = (yy == 0) | (yy == h - 1) | (xx == 0) | (xx == w - 1)
    blurred = torch.where(border[..., None], img, blurred)
    return _blend(img, blurred, factor)


def gaussian_blur(img: torch.Tensor, sigma: torch.Tensor,
                  kernel_size: int = 3) -> torch.Tensor:
    """Separable Gaussian blur with per-image ``sigma`` [B], zero padding
    (torchvision GaussianBlur semantics as the JAX package has them)."""
    r = kernel_size // 2
    xs = torch.arange(-r, r + 1, dtype=torch.float64, device=img.device)
    k = torch.exp(-(xs ** 2) / (2.0 * sigma.double()[:, None] ** 2))
    k = (k / k.sum(-1, keepdim=True)).float()               # [B, k]
    for axis in (1, 2):
        out = None
        for t, tap in enumerate(_taps(img, r, axis)):
            term = _per_image(k[:, t], img) * tap
            out = term if out is None else out + term
        img = out
    return img


# ---------------------------------------------------------------------------
# RandAugment (torchvision's 14-op space, magnitude bins 0..30)
# ---------------------------------------------------------------------------

def randaug_op(img: torch.Tensor, op: int, sign: torch.Tensor,
               magnitude: float) -> torch.Tensor:
    """Op ``op`` of the 14 on the whole batch, signed per image by
    ``sign`` [B] (+1 or -1), at torchvision's magnitudes (frac = m/30)."""
    frac = magnitude / 30.0
    shift = frac * 150.0 / 331.0 * img.shape[1]      # pixels
    if op == 0:
        return img
    if op == 1:
        return shear_x(img, sign * 0.3 * frac)
    if op == 2:
        return shear_y(img, sign * 0.3 * frac)
    if op == 3:
        return translate_x(img, sign * shift)
    if op == 4:
        return translate_y(img, sign * shift)
    if op == 5:
        return rotate(img, sign * 30.0 * frac)
    if op == 6:
        return adjust_brightness(img, 1.0 + sign * 0.9 * frac)
    if op == 7:
        return adjust_saturation(img, 1.0 + sign * 0.9 * frac)  # "Color"
    if op == 8:
        return adjust_contrast(img, 1.0 + sign * 0.9 * frac)
    if op == 9:
        return sharpness(img, 1.0 + sign * 0.9 * frac)
    if op == 10:
        return posterize(img, int(8 - round(frac * 4)))
    if op == 11:
        return solarize(img, 255.0 * (1.0 - frac))
    if op == 12:
        return autocontrast(img)
    if op == 13:
        return equalize(img)
    raise ValueError(f"RandAugment op {op} is not one of 0..13")


def rand_augment(img: torch.Tensor, ops: torch.Tensor, signs: torch.Tensor,
                 magnitude: float) -> torch.Tensor:
    """``ops`` [B, n] op indices and ``signs`` [B, n]: each application
    computes every op on the whole batch and keeps, per image, the one
    it drew (what ``lax.switch`` under ``vmap`` does)."""
    for i in range(ops.shape[1]):
        out = img
        for op in range(1, RANDAUG_OPS):
            out = torch.where(_per_image(ops[:, i] == op, img),
                              randaug_op(img, op, signs[:, i], magnitude),
                              out)
        img = out
    return img


# ---------------------------------------------------------------------------
# erasing + normalize
# ---------------------------------------------------------------------------

def erase_noise(seed: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """N(0, 1) noise [B, *shape] fixed by a per-image ``seed`` [B]:
    Box-Muller over uniforms from a counter hash (murmur3's finalizer)."""
    n = math.prod(shape)
    idx = torch.arange(2 * n, dtype=torch.long, device=seed.device)
    key = fmix32(seed.long() & _M32)[:, None]
    bits = fmix32((idx * _GOLDEN + key) & _M32)
    u = ((bits >> 8).float() + 0.5) * 2.0 ** -24            # (0, 1)
    z = torch.sqrt(-2.0 * torch.log(u[:, :n])) * torch.cos(
        2.0 * math.pi * u[:, n:])
    return z.view(-1, *shape)


def erase(img: torch.Tensor, area: torch.Tensor, log_ratio: torch.Tensor,
          oy: torch.Tensor, ox: torch.Tensor, noise: torch.Tensor
          ) -> torch.Tensor:
    """RandomErasing(value='random'): a box of ``area`` [B] of the image
    (a fraction) and aspect exp(``log_ratio``), its corner at ``oy``,
    ``ox`` [B] anywhere in the image, clipped by the image (not moved),
    filled with ``noise``."""
    h, w = img.shape[1], img.shape[2]
    area = (h * w) * area.float()
    aspect = torch.exp(log_ratio.double())
    eh = torch.clamp(torch.sqrt(area.double() * aspect), 1, h).long()
    ew = torch.clamp(torch.sqrt(area.double() / aspect), 1, w).long()
    yy = torch.arange(h, device=img.device)[None, :, None]
    xx = torch.arange(w, device=img.device)[None, None, :]
    oy, ox = oy[:, None, None], ox[:, None, None]
    mask = ((yy >= oy) & (yy < oy + eh[:, None, None])
            & (xx >= ox) & (xx < ox + ew[:, None, None]))
    return torch.where(mask[..., None], noise, img)


@functools.lru_cache(maxsize=32)
def _channel_stats(mean: Tuple[float, ...], std: Tuple[float, ...],
                   dtype: torch.dtype, device: torch.device):
    """The stats as tensors on ``device``, made once: a copy from pageable
    host memory waits for the card's queue to drain."""
    return (torch.tensor(mean, dtype=dtype, device=device),
            torch.tensor(std, dtype=dtype, device=device))


def normalize(img01: torch.Tensor, mean: Sequence[float],
              std: Sequence[float]) -> torch.Tensor:
    m, s = _channel_stats(tuple(mean), tuple(std), img01.dtype,
                          img01.device)
    return (img01 - m) / s


def resize(img: torch.Tensor, size: int) -> torch.Tensor:
    """Bilinear resize of [B, H, W, C] to ``size`` x ``size``, as
    ``jax.image.resize`` (``nn/resize.py``)."""
    b, _, _, c = img.shape
    return jax_resize(img, (b, size, size, c), "bilinear")


# ---------------------------------------------------------------------------
# the pipelines
# ---------------------------------------------------------------------------

def draw_params(cfg: AugConfig, n: int, generator: torch.Generator
                ) -> Params:
    """Every per-image parameter of ``cfg``'s pipeline for ``n`` images,
    drawn from ``generator`` on its device in a fixed order, with
    ``augment_image``'s distributions."""
    dev = generator.device

    def unif(lo=0.0, hi=1.0, shape=(n,)):
        return lo + (hi - lo) * torch.rand(shape, generator=generator,
                                           device=dev)

    def coin(p, shape=(n,)):
        return torch.rand(shape, generator=generator, device=dev) < p

    def ints(lo, hi, shape=(n,)):
        return torch.randint(lo, hi, shape, generator=generator, device=dev)

    p: Params = {}
    if cfg.rrc_scale is not None:
        p["rrc_area"] = unif(*cfg.rrc_scale)
        p["rrc_log_ratio"] = unif(math.log(3 / 4), math.log(4 / 3))
        p["rrc_y"], p["rrc_x"] = unif(), unif()
    elif cfg.crop_pad > 0:
        p["crop_y"] = ints(0, 2 * cfg.crop_pad + 1)
        p["crop_x"] = ints(0, 2 * cfg.crop_pad + 1)
    if cfg.hflip:
        p["flip"] = coin(0.5)
    if cfg.rotation_deg > 0:
        p["rot_deg"] = unif(-cfg.rotation_deg, cfg.rotation_deg)
    if cfg.jitter is not None:
        b, c, s, hue = cfg.jitter
        p["jitter_do"] = coin(cfg.jitter_prob)
        p["jitter_b"] = unif(max(0.0, 1 - b), 1 + b)
        p["jitter_c"] = unif(max(0.0, 1 - c), 1 + c)
        p["jitter_s"] = unif(max(0.0, 1 - s), 1 + s)
        p["jitter_h"] = unif(-hue, hue)
    if cfg.randaug_ops > 0:
        shape = (n, cfg.randaug_ops)
        p["ra_op"] = ints(0, RANDAUG_OPS, shape)
        p["ra_sign"] = torch.where(coin(0.5, shape), 1.0, -1.0)
    if cfg.blur_prob > 0:
        p["blur_do"] = coin(cfg.blur_prob)
        p["blur_sigma"] = unif(0.1, 2.0)
    if cfg.erasing_prob > 0:
        p["erase_do"] = coin(cfg.erasing_prob)
        p["erase_area"] = unif(*cfg.erasing_scale)
        p["erase_log_ratio"] = unif(math.log(cfg.erasing_ratio[0]),
                                    math.log(cfg.erasing_ratio[1]))
        # the corner, reduced modulo the image side in apply_augment
        p["erase_y"], p["erase_x"] = ints(0, 2 ** 31 - 1), ints(0, 2 ** 31 - 1)
        p["erase_seed"] = ints(0, 2 ** 31 - 1)
    return p


def apply_augment(images_u8: torch.Tensor, params: Params, cfg: AugConfig
                  ) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> normalised float32 [B, H', W', 3] (H' =
    ``cfg.resize_to`` or H) under ``params`` from :func:`draw_params`,
    on the images' device."""
    for k, v in params.items():
        if v.device != images_u8.device:
            raise ValueError(f"parameter {k} is on {v.device}, the images "
                             f"on {images_u8.device}")
    img = images_u8.float()
    if cfg.resize_to is not None:
        img = resize(img, cfg.resize_to)
    if cfg.rrc_scale is not None:
        img = resized_crop(img, params["rrc_area"], params["rrc_log_ratio"],
                           params["rrc_y"], params["rrc_x"])
    elif cfg.crop_pad > 0:
        img = crop(img, params["crop_y"], params["crop_x"], cfg.crop_pad)
    if cfg.hflip:
        img = hflip(img, params["flip"])
    if cfg.rotation_deg > 0:
        img = rotate(img, params["rot_deg"])
    if cfg.jitter is not None:
        b, c, s, hue = cfg.jitter
        jit = img
        if b > 0:
            jit = adjust_brightness(jit, params["jitter_b"])
        if c > 0:
            jit = adjust_contrast(jit, params["jitter_c"])
        if s > 0:
            jit = adjust_saturation(jit, params["jitter_s"])
        if hue > 0:
            jit = adjust_hue(jit, params["jitter_h"])
        img = torch.where(_per_image(params["jitter_do"], img), jit, img)
    if cfg.randaug_ops > 0:
        img = rand_augment(img, params["ra_op"], params["ra_sign"],
                           float(cfg.randaug_magnitude))
    if cfg.blur_prob > 0:
        blurred = gaussian_blur(img, params["blur_sigma"], cfg.blur_kernel)
        img = torch.where(_per_image(params["blur_do"], img), blurred, img)
    img = normalize(img * (1.0 / 255.0), cfg.mean, cfg.std)
    if cfg.erasing_prob > 0:
        h, w = img.shape[1], img.shape[2]
        erased = erase(img, params["erase_area"], params["erase_log_ratio"],
                       params["erase_y"] % h, params["erase_x"] % w,
                       erase_noise(params["erase_seed"], img.shape[1:]))
        img = torch.where(_per_image(params["erase_do"], img), erased, img)
    return img


def augment_batch(images_u8: torch.Tensor, cfg: AugConfig,
                  generator: torch.Generator) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> normalised float32, augmented per image with
    parameters drawn from ``generator`` (on the images' device)."""
    if generator.device.type != images_u8.device.type:
        raise ValueError(f"the generator is on {generator.device}, the "
                         f"images on {images_u8.device}")
    return apply_augment(images_u8, draw_params(cfg, images_u8.shape[0],
                                                generator), cfg)


def eval_batch(images_u8: torch.Tensor, cfg: AugConfig) -> torch.Tensor:
    """Validation path: [resize +] normalize
    (HQAViT_CIFAR100.py:1304-1307; QAViT.py:722-726)."""
    img = images_u8.float()
    if cfg.resize_to is not None:
        img = resize(img, cfg.resize_to)
    return normalize(img * (1.0 / 255.0), cfg.mean, cfg.std)
