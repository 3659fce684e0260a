"""Dataset sources of the port (its own copy of ``qavit_tpu/data/
datasets.py``): the normalisation statistics, the procedural substrates
of ``data/procgen.py``, the label-scarce subsample and ``load_dataset``
with the JAX package's synthetic fallback.

The readers of CIFAR-10/100, STL-10 and Tiny-ImageNet files
(``qavit_tpu/data/datasets.py:75-170``) are not ported yet (ROADMAP.md
queue 1 item 3): where their files are absent ``load_dataset`` returns
the synthetic set exactly where the JAX package does; where they are
present it raises rather than serve synthetic data in their place.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from qavit_tpu_torch.data import procgen

# per-dataset normalisation stats, as hard-coded in the reference trainers
STATS = {
    "cifar10": ((0.4914, 0.4822, 0.4465), (0.2470, 0.2435, 0.2616)),
    "cifar100": ((0.5071, 0.4867, 0.4408), (0.2675, 0.2565, 0.2761)),
    "stl10": ((0.4467, 0.4398, 0.4066), (0.2603, 0.2566, 0.2713)),
    "tiny_imagenet": ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
    # the procedural substrates (data/procgen.py)
    "proc100": ((0.5, 0.5, 0.5), (0.25, 0.25, 0.25)),
    "proc10": ((0.5, 0.5, 0.5), (0.25, 0.25, 0.25)),
    "proc_stl": ((0.5, 0.5, 0.5), (0.25, 0.25, 0.25)),
    "proc_tin": ((0.5, 0.5, 0.5), (0.25, 0.25, 0.25)),
}


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


# name -> (loader in procgen, number of classes); generated, but real
# learning tasks (train and test are disjoint draws of one process)
_PROCEDURAL = {
    "proc100": (procgen.load_or_generate_proc100, 100),
    "proc100_hard": (procgen.load_or_generate_proc100_hard, 100),
    "proc10": (procgen.load_or_generate_proc10, 10),
    "proc_stl": (procgen.load_or_generate_proc_stl, 100),
    "proc224": (procgen.load_or_generate_proc224, 100),
    "proc_stl50k": (procgen.load_or_generate_proc_stl50k, 100),
    "proc_tin": (procgen.load_or_generate_proc_tin, 200),
}

# name -> the files whose presence makes the JAX package read the set
# (``qavit_tpu/data/datasets.py``: cifar :75-90, stl10 :113-115,
# tiny_imagenet :139-146)
_READER_FILES = {
    "cifar10": ("cifar-10-batches-py/data_batch_1",),
    "cifar100": ("cifar-100-python/train",),
    "stl10": ("stl10_binary/train_X.bin",),
    "stl10_unlabeled": ("stl10_binary/train_X.bin",),
    "tiny_imagenet": ("tiny-imagenet-200/wnids.txt",
                      "tiny-imagenet-200.zip"),
}

# name -> (image size, number of classes) of the synthetic fallback
SIZES = {"cifar10": (32, 10), "cifar100": (32, 100),
         "stl10": (96, 10), "stl10_unlabeled": (96, 10),
         "tiny_imagenet": (64, 200), "proc100": (32, 100),
         "proc100_hard": (32, 100), "proc10": (32, 10),
         "proc_stl": (96, 100), "proc_stl50k": (96, 100),
         "proc_tin": (64, 200), "proc224": (224, 100)}


def _load_procedural(name: str, root: str) -> Dataset:
    load, num_classes = _PROCEDURAL[name]
    tr_x, tr_y, te_x, te_y = load(root)
    return Dataset(name, tr_x, tr_y, te_x, te_y, num_classes)


def subsample_per_class(ds: Dataset, k: int) -> Dataset:
    """Label-scarce protocol: keep the first ``k`` occurrences of each
    class (in dataset order), so every arm of a pretrain-vs-scratch
    comparison sees the same labelled subset."""
    y = np.asarray(ds.train_labels)
    order = np.argsort(y, kind="stable")
    starts = np.unique(y[order], return_index=True)[1][1:]
    keep = np.sort(np.concatenate(
        [idx[:k] for idx in np.split(order, starts)]))
    return dataclasses.replace(ds, train_images=ds.train_images[keep],
                               train_labels=ds.train_labels[keep])


def load_dataset(name: str, data_root: str = "./data",
                 allow_synthetic: bool = True) -> Dataset:
    """Load a dataset by base name: a procedural substrate (generated
    once and cached as ``<data_root>/<name>.npz``) or, for a reader
    dataset whose files are absent, the synthetic set (2048 / 512 images
    from seed 0) unless ``allow_synthetic`` is False.  An unknown name
    raises ``KeyError``."""
    if name not in SIZES:
        raise KeyError(f"unknown dataset {name!r}")
    if name in _PROCEDURAL:
        return _load_procedural(name, data_root)
    present = [f for f in _READER_FILES[name]
               if (Path(data_root) / f).exists()]
    if present:
        raise NotImplementedError(
            f"{name}: {Path(data_root) / present[0]} exists, but the port "
            f"does not read {name} files yet (ROADMAP.md queue 1 item 3); "
            f"it serves no synthetic data in their place")
    if not allow_synthetic:
        raise FileNotFoundError(f"dataset {name} not found under "
                                f"{data_root}")
    img, ncls = SIZES[name]
    return synthetic_dataset(name, img, ncls)
