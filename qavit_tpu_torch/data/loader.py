"""Batch loaders of the port (counterpart of ``qavit_tpu/data/loader.py``,
single process).

``BatchLoader`` keeps the whole uint8 dataset in host memory, shuffles
the indices per epoch with the JAX package's ``RandomState(seed)`` (so
both yield the same order) and copies one batch ahead to the device, from
pinned host memory with ``non_blocking=True``: the copy of batch i+1
overlaps the step on batch i, as JAX's async ``device_put`` does.
``IndexLoader`` serves a dataset already resident on the device: it
uploads each epoch's permutation once and yields slices of it, device
index tensors.  All augmentation happens on the device
(``data/augment.py``).

The multi-host loading of the JAX package (``process_local_indices``,
``make_array_from_process_local_data``) waits for ROADMAP.md queue 1
item 10; passing its arguments raises.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch


def _num_batches(n: int, batch_size: int, drop_last: bool) -> int:
    return n // batch_size if drop_last else -(-n // batch_size)


def _single_process(process_count: Optional[int],
                    process_index: Optional[int]) -> None:
    if (process_count or 1) > 1 or (process_index or 0) > 0:
        raise NotImplementedError(
            "multi-host loading is not ported yet (ROADMAP.md queue 1 "
            "item 10)")


class BatchLoader:
    """Iterates (device uint8 images [B, H, W, 3], device int64 labels
    [B]) over ``images`` / ``labels`` held on the host."""

    def __init__(self, images: np.ndarray, labels: np.ndarray,
                 batch_size: int, shuffle: bool = True, seed: int = 0,
                 drop_last: bool = True, device="cpu",
                 process_count: Optional[int] = None,
                 process_index: Optional[int] = None):
        _single_process(process_count, process_index)
        if images.ndim != 4 or images.dtype != np.uint8:
            raise ValueError(f"images must be uint8 [N, H, W, C], got "
                             f"{images.dtype} {images.shape}")
        self.images = images
        self.labels = labels.astype(np.int64)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.device = torch.device(device)
        self._rng = np.random.RandomState(seed)
        # two pinned staging buffers, each reused once its copy is done
        self._staging: List[Optional[Tuple[torch.Tensor, torch.Tensor]]] = \
            [None, None]
        self._copied: List[Optional[torch.cuda.Event]] = [None, None]

    def __len__(self) -> int:
        return _num_batches(len(self.images), self.batch_size,
                            self.drop_last)

    def _put(self, sel: np.ndarray, slot: int):
        if self.device.type != "cuda":
            return (torch.from_numpy(self.images[sel]).to(self.device),
                    torch.from_numpy(self.labels[sel]).to(self.device))
        if self._staging[slot] is None:
            self._staging[slot] = (
                torch.empty((self.batch_size,) + self.images.shape[1:],
                            dtype=torch.uint8).pin_memory(),
                torch.empty(self.batch_size, dtype=torch.int64).pin_memory())
        if self._copied[slot] is not None:
            self._copied[slot].synchronize()
        x, y = (t[:len(sel)] for t in self._staging[slot])
        np.take(self.images, sel, axis=0, out=x.numpy())
        np.take(self.labels, sel, axis=0, out=y.numpy())
        out = (x.to(self.device, non_blocking=True),
               y.to(self.device, non_blocking=True))
        self._copied[slot] = torch.cuda.Event()
        self._copied[slot].record()
        return out

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        idx = np.arange(len(self.images))
        if self.shuffle:
            self._rng.shuffle(idx)
        bs = self.batch_size
        pending = None
        for i in range(len(self)):
            nxt = self._put(idx[i * bs:(i + 1) * bs], i % 2)
            if pending is not None:
                yield pending
            pending = nxt
        if pending is not None:
            yield pending


class IndexLoader:
    """Loader for a dataset resident on the device: each iteration yields
    a device int64 index tensor [batch] (shuffled per epoch with the JAX
    package's ``RandomState(seed)``); the permutation crosses the host
    link once an epoch instead of the images every step."""

    def __init__(self, n: int, batch_size: int, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True, device="cpu"):
        self.n = n
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.device = torch.device(device)
        self._rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        return _num_batches(self.n, self.batch_size, self.drop_last)

    def __iter__(self) -> Iterator[torch.Tensor]:
        idx = np.arange(self.n)
        if self.shuffle:
            self._rng.shuffle(idx)
        # one upload an epoch: a copy from pageable memory waits for the
        # card's queue to drain, which a copy per step would do every step
        idx = torch.from_numpy(idx).to(self.device)
        bs = self.batch_size
        for i in range(len(self)):
            yield idx[i * bs:(i + 1) * bs]
