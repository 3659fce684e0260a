"""Procedurally generated image substrates (the port's own copy of
``qavit_tpu/data/procgen.py``: numpy only, nothing of ``qavit_tpu``).

proc100 is CIFAR-100-shaped (50k train / 10k test, 32x32x3 uint8, 100
classes): class identity is a 2-D spatial frequency pair ``(f_x, f_y)``
in ``{1..10} x {1..10}`` rendered as a separable cosine grating, plus a
class-keyed colour palette; nuisance factors (phases, amplitude,
brightness, contrast, a diagonal harmonic, pixel noise) are drawn per
sample.  ``hard=True`` (proc100_hard) makes the palette per sample, mixes
in a weaker grating of a wrong class and occludes a square.

The ``RandomState`` calls are the JAX package's, in its order: on one
machine the arrays equal its arrays bit for bit, and a cache written by
either package (``<data_root>/<name>.npz``: ``train_images``,
``train_labels``, ``test_images``, ``test_labels``) is read by the other.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

# proc100 renders around mid-gray by construction; nominal stats used by
# the normalization pipeline (analogous to the hard-coded CIFAR stats).
PROC100_STATS = ((0.5, 0.5, 0.5), (0.25, 0.25, 0.25))


def _class_palette(num_classes: int, rng: np.random.RandomState):
    """Two colors per class, keyed on the class index (secondary cue)."""
    a = rng.uniform(0.35, 1.0, (num_classes, 3)).astype(np.float32)
    b = rng.uniform(0.0, 0.65, (num_classes, 3)).astype(np.float32)
    return a, b


def generate_proc100(n: int, seed: int, img_size: int = 32,
                     num_classes: int = 100, batch: int = 4096,
                     hard: bool = False):
    """Generate ``n`` (image, label) pairs. Returns (uint8 NHWC, int32).

    ``hard=True`` removes every shortcut: the class-keyed palette becomes
    a per-sample random palette (colour carries no class information), a
    distractor grating from a random wrong class is mixed in at 0.2-0.5
    amplitude (the stronger grating is always the label), and a random
    occluding square erases part of the evidence.  The easy variant
    saturates a 6.5M-parameter model by epoch ~3; hard is built to give a
    non-saturating curve over a full schedule."""
    rng = np.random.RandomState(seed)
    pal_a, pal_b = _class_palette(num_classes, np.random.RandomState(1234))

    side = np.arange(img_size, dtype=np.float32) / img_size
    yy = side[:, None]          # [H, 1]
    xx = side[None, :]          # [1, W]

    images = np.empty((n, img_size, img_size, 3), np.uint8)
    labels = rng.randint(0, num_classes, n).astype(np.int32)

    def grating(y, m, amp_lo, amp_hi):
        f_x = (1 + y % 10).astype(np.float32)[:, None, None]
        f_y = (1 + y // 10).astype(np.float32)[:, None, None]
        ph_x = rng.uniform(0, 2 * np.pi, (m, 1, 1)).astype(np.float32)
        ph_y = rng.uniform(0, 2 * np.pi, (m, 1, 1)).astype(np.float32)
        amp = rng.uniform(amp_lo, amp_hi, (m, 1, 1)).astype(np.float32)
        two_pi = np.float32(2 * np.pi)
        return amp * (np.cos(two_pi * f_x * xx + ph_x)
                      * np.cos(two_pi * f_y * yy + ph_y))

    for lo in range(0, n, batch):
        hi = min(lo + batch, n)
        m = hi - lo
        y = labels[lo:hi]
        two_pi = np.float32(2 * np.pi)

        if hard:
            ph_d = rng.uniform(0, 2 * np.pi, (m, 1, 1)).astype(np.float32)
            harm = rng.uniform(0.0, 0.3, (m, 1, 1)).astype(np.float32)
            g = grating(y, m, 0.7, 1.0)
            # distractor grating from a random WRONG class, weaker by
            # construction — the model must pick the dominant frequency
            y_wrong = (y + rng.randint(1, num_classes, m)) % num_classes
            g = g + grating(y_wrong.astype(np.int32), m, 0.2, 0.5)
        else:
            # the per-batch draw order (ph_x, ph_y, ph_d, amp, harm) is
            # load-bearing: the documented seeds regenerate the
            # proc100/proc10/proc_stl/proc_tin caches bit-identically
            ph_x = rng.uniform(0, 2 * np.pi, (m, 1, 1)).astype(np.float32)
            ph_y = rng.uniform(0, 2 * np.pi, (m, 1, 1)).astype(np.float32)
            ph_d = rng.uniform(0, 2 * np.pi, (m, 1, 1)).astype(np.float32)
            amp = rng.uniform(0.7, 1.0, (m, 1, 1)).astype(np.float32)
            harm = rng.uniform(0.0, 0.3, (m, 1, 1)).astype(np.float32)
            f_x = (1 + y % 10).astype(np.float32)[:, None, None]
            f_y = (1 + y // 10).astype(np.float32)[:, None, None]
            g = amp * (np.cos(two_pi * f_x * xx + ph_x)
                       * np.cos(two_pi * f_y * yy + ph_y))
        # nuisance diagonal harmonic at a class-independent frequency
        g = g + harm * np.cos(two_pi * 3.0 * (xx + yy) + ph_d)
        g = (g + 1.8) / 3.6 if hard else (g + 1.3) / 2.6     # -> ~[0, 1]

        if hard:
            # per-sample random palette: color is pure nuisance
            ca = rng.uniform(0.35, 1.0, (m, 3)).astype(np.float32)
            cb = rng.uniform(0.0, 0.65, (m, 3)).astype(np.float32)
        else:
            ca, cb = pal_a[y], pal_b[y]
        img = (g[..., None] * ca[:, None, None, :]
               + (1.0 - g[..., None]) * cb[:, None, None, :])

        if hard:
            # occluding square (evidence deletion, not just noise)
            s = max(2, img_size // 4)
            oy = rng.randint(0, img_size - s, m)
            ox = rng.randint(0, img_size - s, m)
            fill = rng.uniform(0, 1, (m, 1, 1, 3)).astype(np.float32)
            ridx = np.arange(img_size)
            my = (ridx[None, :] >= oy[:, None]) & \
                 (ridx[None, :] < (oy + s)[:, None])
            mx = (ridx[None, :] >= ox[:, None]) & \
                 (ridx[None, :] < (ox + s)[:, None])
            occ = (my[:, :, None] & mx[:, None, :])[..., None]
            img = np.where(occ, fill, img)

        contrast = rng.uniform(0.8, 1.2, (m, 1, 1, 1)).astype(np.float32)
        bright = rng.uniform(-0.08, 0.08, (m, 1, 1, 1)).astype(np.float32)
        img = (img - 0.5) * contrast + 0.5 + bright
        noise = 0.06 if hard else 0.04
        img = img + rng.normal(0, noise, img.shape).astype(np.float32)

        images[lo:hi] = np.clip(img * 255.0, 0, 255).astype(np.uint8)
    return images, labels


def _load_or_generate(data_root: str, name: str, num_classes: int,
                      n_train: int, n_test: int, seeds=(0, 1), **kw):
    """``<data_root>/<name>.npz`` if it exists, else the train split from
    ``seeds[0]`` and the test split from ``seeds[1]`` (``kw`` goes to
    :func:`generate_proc100`), written there compressed."""
    cache = Path(data_root) / f"{name}.npz"
    if cache.exists():
        z = np.load(cache)
        return (z["train_images"], z["train_labels"],
                z["test_images"], z["test_labels"])
    tr_x, tr_y = generate_proc100(n_train, seed=seeds[0],
                                  num_classes=num_classes, **kw)
    te_x, te_y = generate_proc100(n_test, seed=seeds[1],
                                  num_classes=num_classes, **kw)
    os.makedirs(data_root, exist_ok=True)
    np.savez_compressed(cache, train_images=tr_x, train_labels=tr_y,
                        test_images=te_x, test_labels=te_y)
    return tr_x, tr_y, te_x, te_y


def load_or_generate_proc100(data_root: str, n_train: int = 50000,
                             n_test: int = 10000):
    """proc100 (seeds 0 / 1), cached under ``data_root``."""
    return _load_or_generate(data_root, "proc100", 100, n_train, n_test)


def load_or_generate_proc100_hard(data_root: str, n_train: int = 50000,
                                  n_test: int = 10000):
    """proc100_hard (seeds 6 / 7): the shortcut-free variant."""
    return _load_or_generate(data_root, "proc100_hard", 100, n_train,
                             n_test, seeds=(6, 7), hard=True)


def load_or_generate_proc10(data_root: str, n_train: int = 10000,
                            n_test: int = 2000):
    """proc10 (seeds 0 / 1): classes 0-9 of the same process (f_y fixed
    at 1), the stand-in for the CIFAR-10 transfer target."""
    return _load_or_generate(data_root, "proc10", 10, n_train, n_test)


def load_or_generate_proc_tin(data_root: str, n_train: int = 100000,
                              n_test: int = 10000):
    """proc_tin (seeds 4 / 5): 200 classes at 64 px, TinyImageNet-shaped;
    ``(f_x, f_y)`` in ``{1..10} x {1..20}``."""
    return _load_or_generate(data_root, "proc_tin", 200, n_train, n_test,
                             seeds=(4, 5), img_size=64)


def load_or_generate_proc224(data_root: str, n_train: int = 10000,
                             n_test: int = 2000):
    """proc224 (seeds 8 / 9): the proc100 process rendered at 224 px,
    generated 512 images at a time (a 4096-image float32 batch at 224
    would be ~2.4 GB)."""
    return _load_or_generate(data_root, "proc224", 100, n_train, n_test,
                             seeds=(8, 9), img_size=224, batch=512)


def load_or_generate_proc_stl50k(data_root: str, n_train: int = 50000,
                                 n_test: int = 1000):
    """proc_stl50k (seeds 10 / 11): a 50k-image 96 px pool, the SimCLR
    pretraining corpus (its labels exist only for the loader)."""
    return _load_or_generate(data_root, "proc_stl50k", 100, n_train, n_test,
                             seeds=(10, 11), img_size=96, batch=1024)


def load_or_generate_proc_stl(data_root: str, n_train: int = 5000,
                              n_test: int = 1000):
    """proc_stl (seeds 2 / 3): 96 px images of the proc100 process."""
    return _load_or_generate(data_root, "proc_stl", 100, n_train, n_test,
                             seeds=(2, 3), img_size=96)
