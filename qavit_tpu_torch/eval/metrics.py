"""Evaluation (counterpart of ``qavit_tpu/eval/metrics.py``): top-1 /
top-5 over a loader, the confusion matrix, the per-class report, the
best and worst classes, the prediction grid and the TTA ensemble.

``evaluate`` and ``validate_tta`` keep their sums on the device until the
loop ends, so the batches queue on the card without a sync each.  The
per-class analysis is numpy on the host over the collected predictions;
the two plots import matplotlib when called and, where it is not
installed, print one line and return None.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Sequence

import numpy as np
import torch

from qavit_tpu_torch.obs.metrics import pyplot_or_none


def evaluate(eval_step: Callable, loader: Iterable,
             preprocess: Optional[Callable] = None,
             collect_logits: bool = False) -> Dict:
    """Average loss and top-1 / top-5 percentages over ``loader``'s
    ``(images, labels)`` batches (``collect_logits``: also every batch's
    logits and labels, as numpy arrays)."""
    sums: Dict[str, torch.Tensor] = {}
    logits, labels_all = [], []
    for images, labels in loader:
        if preprocess is not None:
            images = preprocess(images)
        m = eval_step(images, labels)
        for k in ("loss_sum", "top1", "top5"):
            sums[k] = sums[k] + m[k] if k in sums else m[k]
        sums["count"] = sums.get("count", 0) + int(m["count"])
        if collect_logits:
            logits.append(m["logits"].float())
            labels_all.append(labels)
    count = max(int(sums.get("count", 0)), 1)
    out = {
        "loss": float(sums.get("loss_sum", 0.0)) / count,
        "top1": 100.0 * float(sums.get("top1", 0)) / count,
        "top5": 100.0 * float(sums.get("top5", 0)) / count,
        "count": int(sums.get("count", 0)),
    }
    if collect_logits:
        out["logits"] = torch.cat(logits).cpu().numpy()
        out["labels"] = torch.cat(labels_all).cpu().numpy()
    return out


def confusion_matrix(preds: np.ndarray, labels: np.ndarray,
                     num_classes: int) -> np.ndarray:
    cm = np.zeros((num_classes, num_classes), np.int64)
    np.add.at(cm, (np.asarray(labels), np.asarray(preds)), 1)
    return cm


def classification_report(preds: np.ndarray, labels: np.ndarray,
                          num_classes: int) -> Dict[int, Dict[str, float]]:
    """Per-class precision / recall / f1 and support."""
    preds, labels = np.asarray(preds), np.asarray(labels)
    report = {}
    for c in range(num_classes):
        tp = int(((preds == c) & (labels == c)).sum())
        fp = int(((preds == c) & (labels != c)).sum())
        fn = int(((preds != c) & (labels == c)).sum())
        prec = tp / (tp + fp) if tp + fp else 0.0
        rec = tp / (tp + fn) if tp + fn else 0.0
        f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
        report[c] = {"precision": prec, "recall": rec, "f1": f1,
                     "support": tp + fn}
    return report


def best_worst_classes(report: Dict[int, Dict[str, float]], k: int = 10,
                       class_names: Optional[Sequence[str]] = None):
    """Best / worst k classes by precision (test_hqa.py:181-195)."""
    ranked = sorted(report.items(), key=lambda kv: -kv[1]["precision"])
    name = (lambda c: class_names[c]) if class_names else str
    best = [(name(c), r["precision"]) for c, r in ranked[:k]]
    worst = [(name(c), r["precision"]) for c, r in ranked[-k:]]
    return best, worst


def plot_confusion_matrix(cm: np.ndarray, out_path: str,
                          class_names: Optional[Sequence[str]] = None):
    plt = pyplot_or_none(out_path)
    if plt is None:
        return None
    fig, ax = plt.subplots(figsize=(12, 10))
    im = ax.imshow(cm, cmap="Blues")
    fig.colorbar(im)
    ax.set_xlabel("Predicted")
    ax.set_ylabel("True")
    ax.set_title("Confusion Matrix")
    fig.tight_layout()
    fig.savefig(out_path, dpi=100)
    plt.close(fig)
    return out_path


def visualize_predictions(images_u8: np.ndarray, preds: np.ndarray,
                          labels: np.ndarray, out_path: str,
                          class_names: Optional[Sequence[str]] = None,
                          n: int = 10):
    """2x5 prediction grid with green / red titles (test_hqa.py:198-223)."""
    plt = pyplot_or_none(out_path)
    if plt is None:
        return None
    n = min(n, len(images_u8))
    cols = 5
    rows = (n + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, figsize=(3 * cols, 3 * rows))
    axes = np.atleast_2d(axes)
    name = (lambda c: class_names[c]) if class_names else str
    for i in range(rows * cols):
        ax = axes[i // cols, i % cols]
        ax.axis("off")
        if i >= n:
            continue
        ax.imshow(images_u8[i])
        ok = preds[i] == labels[i]
        ax.set_title(f"P: {name(int(preds[i]))}\nT: {name(int(labels[i]))}",
                     color="green" if ok else "red", fontsize=9)
    fig.tight_layout()
    fig.savefig(out_path, dpi=100)
    plt.close(fig)
    return out_path


def validate_tta(forward: Callable, loaders: Iterable,
                 preprocessors: Sequence[Callable]) -> Dict[str, float]:
    """TTA: the argmax of the summed softmax probabilities of the views
    (HQAViT_C100_Finetune.py:346-384).  ``loaders`` yield aligned
    ``(images_u8, labels)`` batches, one loader per view; each
    preprocessor makes its view, normalised, on the images' device;
    ``forward(images) -> logits``."""
    correct = 0
    total = 0
    for batches in zip(*loaders):
        labels = batches[0][1]
        probs = None
        for (images, _), prep in zip(batches, preprocessors):
            p = torch.softmax(forward(prep(images)).float(), dim=-1)
            probs = p if probs is None else probs + p
        correct = correct + (probs.argmax(-1) == labels).sum()
        total += len(labels)
    return {"tta_top1": 100.0 * float(correct) / max(total, 1),
            "count": total}
