"""Training-log parsers and plotters (counterpart of
``qavit_tpu/obs/log_parse.py``; the reference's visual_hqa450.py:12-144).

Parses the epoch-summary blocks of a plain-text training log, the block
``TrainingLogger.print_epoch_summary`` prints (``cli.train``'s standard
output), into a history dict with ``training_metrics.json``'s keys, and
draws the curve dashboard where matplotlib is installed.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, List, Optional

from qavit_tpu_torch.obs.metrics import pyplot_or_none

_EPOCH_RE = re.compile(r"Epoch (\d+) Summary")
_ROW_RES = {
    "train_loss": re.compile(r"Train Loss\s+([\d.]+)"),
    "train_acc": re.compile(r"Train Acc \(%\)\s+([\d.]+)"),
    "val_loss": re.compile(r"Val Loss\s+([\d.]+)"),
    "val_acc": re.compile(r"Val Acc \(%\)\s+([\d.]+)"),
    "ema_val_acc": re.compile(r"EMA Val Acc \(%\)\s+([\d.]+)"),
    "ema_param_dist": re.compile(r"EMA Param Distance\s+([\d.]+)"),
    "lr": re.compile(r"Learning Rate\s+([\d.eE+-]+)"),
    "grad_norm": re.compile(r"Grad Norm\s+([\d.]+)"),
    "epoch_time": re.compile(r"Time \(seconds\)\s+([\d.]+)"),
}


def parse_training_log(path: str) -> Dict[str, List[float]]:
    """Epoch-summary blocks -> a history dict (training_metrics.json's
    keys)."""
    text = Path(path).read_text(errors="replace")
    blocks = _EPOCH_RE.split(text)
    history: Dict[str, List[float]] = {"epoch": []}
    # split gives [before, epoch 1, body 1, epoch 2, body 2, ...]
    for i in range(1, len(blocks) - 1, 2):
        history["epoch"].append(int(blocks[i]))
        body = blocks[i + 1]
        for key, rex in _ROW_RES.items():
            m = rex.search(body)
            if m:
                history.setdefault(key, []).append(float(m.group(1)))
    return history


def to_dataframe(history: Dict[str, List[float]]):
    import pandas as pd

    n = len(history.get("epoch", []))
    return pd.DataFrame({k: v for k, v in history.items() if len(v) == n})


def plot_history(history: Dict[str, List[float]], out_path: str,
                 title: Optional[str] = None) -> Optional[str]:
    """Loss / accuracy / LR / grad-norm dashboard of a parsed log; None
    without matplotlib or epochs."""
    ep = history.get("epoch", [])
    if not ep:
        return None
    plt = pyplot_or_none(Path(out_path).name)
    if plt is None:
        return None
    fig, axes = plt.subplots(2, 2, figsize=(14, 9))
    panels = [(["train_loss", "val_loss"], "Loss"),
              (["train_acc", "val_acc", "ema_val_acc"], "Accuracy (%)"),
              (["lr"], "Learning Rate"), (["grad_norm"], "Grad Norm")]
    for ax, (keys, name) in zip(axes.flat, panels):
        for k in keys:
            if k in history:
                ax.plot(ep[:len(history[k])], history[k], label=k)
        ax.set_title(name)
        ax.set_xlabel("epoch")
        ax.legend()
        ax.grid(alpha=0.3)
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    fig.savefig(out_path, dpi=100)
    plt.close(fig)
    return out_path
