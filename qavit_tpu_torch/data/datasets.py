"""Dataset sources of the port (its own copy of what it needs from
``qavit_tpu/data/datasets.py``): the normalisation statistics and the
deterministic synthetic set (``datasets.py:58-72``).  Reading CIFAR /
STL / Tiny-ImageNet from disk waits for a later slice."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# per-dataset normalisation stats, as hard-coded in the reference trainers
STATS = {
    "cifar100": ((0.5071, 0.4867, 0.4408), (0.2675, 0.2565, 0.2761)),
}
# the base dataset of each pipeline name a preset uses
PIPELINE_BASE = {"cifar100_hqa": "cifar100"}


@dataclass
class Dataset:
    """In-memory image classification dataset (images uint8 NHWC)."""

    name: str
    train_images: np.ndarray
    train_labels: np.ndarray
    test_images: np.ndarray
    test_labels: np.ndarray
    num_classes: int
    synthetic: bool = False


def synthetic_dataset(name: str, img_size: int, num_classes: int,
                      n_train: int = 2048, n_test: int = 512,
                      seed: int = 0) -> Dataset:
    """Random images with a class-dependent shift (so a model can fit
    them); seed 0 and the default sizes give the JAX package's set."""
    rng = np.random.RandomState(seed)

    def make(n):
        labels = rng.randint(0, num_classes, n).astype(np.int32)
        base = rng.randint(0, 255, (n, img_size, img_size, 3))
        shift = labels[:, None, None, None] * 255 // num_classes
        return ((base + shift) // 2).astype(np.uint8), labels

    tr_x, tr_y = make(n_train)
    te_x, te_y = make(n_test)
    return Dataset(name, tr_x, tr_y, te_x, te_y, num_classes, synthetic=True)
