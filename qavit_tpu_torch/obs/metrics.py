"""Training metrics logging — ``training_metrics.json`` with the JAX
package's keys and layout (counterpart of ``qavit_tpu/obs/metrics.py``).

A history dict keyed as the reference's TrainingLogger
(HQAViT_Tiny_Cifar10.py:67-258) and TrainingHistory
(HQAViT_IN_Tiny.py:227-456) key it ({'history': {epoch, train_loss,
train_acc, val_loss, val_acc, lr, grad_norm, epoch_time, [ema_val_loss,
ema_val_acc, ema_param_dist]}, 'best_val_acc', 'total_time'}), the
reference's epoch-summary block, and the matplotlib dashboards.  The
plots import matplotlib when called; where it is not installed each
prints one line and returns None, and the JSON stays the record.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Dict, Optional


def pyplot_or_none(out_name: str):
    """matplotlib's pyplot on the Agg backend, or None (with one line
    printed) where matplotlib is not installed."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print(f"matplotlib is not installed: {out_name} not written")
        return None
    return plt


BASE_KEYS = ("epoch", "train_loss", "train_acc", "val_loss", "val_acc",
             "lr", "grad_norm", "epoch_time")
EMA_KEYS = ("ema_val_loss", "ema_val_acc", "ema_param_dist")


class TrainingLogger:
    def __init__(self, log_dir: str, track_ema: bool = False,
                 resume: bool = False):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        keys = BASE_KEYS + (EMA_KEYS if track_ema else ())
        self.history: Dict[str, list] = {k: [] for k in keys}
        self.best_val_acc = 0.0
        self.best_ema_val_acc = 0.0
        self.start_time = time.time()
        if resume:
            # a --resume'd run continues the SAME history file instead of
            # overwriting the pre-interruption epochs
            prior = self.log_dir / "training_metrics.json"
            if prior.exists():
                with open(prior) as f:
                    d = json.load(f)
                for k, v in d.get("history", {}).items():
                    if k in self.history:
                        self.history[k] = list(v)
                self.best_val_acc = float(d.get("best_val_acc", 0.0))
                self.start_time -= float(d.get("total_time", 0.0))

    def log_epoch(self, epoch: int, metrics: Dict[str, float]) -> None:
        # resume overlap: drop any logged epochs >= this one (the resumed
        # run re-trains them)
        if self.history["epoch"] and self.history["epoch"][-1] >= epoch:
            keep = sum(1 for e in self.history["epoch"] if e < epoch)
            for k in self.history:
                self.history[k] = self.history[k][:keep]
        self.history["epoch"].append(epoch)
        for key, value in metrics.items():
            if key in self.history:
                self.history[key].append(float(value))
        if metrics.get("val_acc", -1.0) > self.best_val_acc:
            self.best_val_acc = float(metrics["val_acc"])
        if metrics.get("ema_val_acc", -1.0) > self.best_ema_val_acc:
            self.best_ema_val_acc = float(metrics["ema_val_acc"])

    def save(self) -> Path:
        """Write the JSON under a temporary name and move it into place,
        so a run stopped while saving leaves the previous file whole."""
        out = self.log_dir / "training_metrics.json"
        tmp = out.with_name(out.name + ".tmp")
        with open(tmp, "w") as f:
            json.dump({
                "history": self.history,
                "best_val_acc": self.best_val_acc,
                "total_time": time.time() - self.start_time,
            }, f, indent=2)
        os.replace(tmp, out)
        return out

    # reference epoch-summary print block (format is load-bearing: the
    # visual_hqa450.py parsers regex it — SURVEY.md §5.5)
    def print_epoch_summary(self, epoch: int, metrics: Dict[str, float],
                            extra: Optional[Dict[str, float]] = None):
        print("=" * 100)
        print(f"Epoch {epoch} Summary")
        rows = [("Train Loss", "train_loss"), ("Train Acc (%)", "train_acc"),
                ("Val Loss", "val_loss"), ("Val Acc (%)", "val_acc"),
                ("EMA Val Acc (%)", "ema_val_acc"),
                ("EMA Param Distance", "ema_param_dist"),
                ("Learning Rate", "lr"), ("Grad Norm", "grad_norm"),
                ("Time (seconds)", "epoch_time")]
        for label, key in rows:
            if key in metrics:
                print(f"{label:<38} {metrics[key]:.4f}")
        for label, value in (extra or {}).items():
            print(f"{label:<38} {value}")
        print("=" * 100)

    def plot(self) -> Optional[Path]:
        """Multi-panel training dashboard
        (HQAViT_Tiny_Cifar10.py:110-258)."""
        plt = pyplot_or_none("training_curves.png")
        if plt is None:
            return None
        h = self.history
        if not h["epoch"]:
            return None
        fig, axes = plt.subplots(2, 3, figsize=(18, 10))
        ep = h["epoch"]

        def _plot(ax, keys, title, ylabel):
            for k in keys:
                if h.get(k):
                    ax.plot(ep[:len(h[k])], h[k], label=k)
            ax.set_title(title)
            ax.set_xlabel("epoch")
            ax.set_ylabel(ylabel)
            ax.legend()
            ax.grid(alpha=0.3)

        _plot(axes[0, 0], ["train_loss", "val_loss"], "Loss", "loss")
        _plot(axes[0, 1], ["train_acc", "val_acc", "ema_val_acc"],
              "Accuracy", "%")
        _plot(axes[0, 2], ["lr"], "Learning Rate", "lr")
        _plot(axes[1, 0], ["grad_norm"], "Gradient Norm", "norm")
        # overfit gap
        if h.get("train_acc") and h.get("val_acc"):
            n = min(len(h["train_acc"]), len(h["val_acc"]))
            gap = [t - v for t, v in zip(h["train_acc"][:n],
                                         h["val_acc"][:n])]
            axes[1, 1].plot(ep[:n], gap)
            axes[1, 1].set_title("Overfit Gap (train-val acc)")
            axes[1, 1].grid(alpha=0.3)
        _plot(axes[1, 2], ["epoch_time"], "Epoch Time", "s")
        fig.tight_layout()
        out = self.log_dir / "training_curves.png"
        fig.savefig(out, dpi=100)
        plt.close(fig)
        return out

    def plot_ema_distance(self) -> Optional[Path]:
        """Standalone EMA tracking-distance plot
        (HQAViT_IN_Tiny.py:336-358)."""
        h = self.history
        if not h.get("ema_param_dist"):
            return None
        plt = pyplot_or_none("ema_distance.png")
        if plt is None:
            return None
        fig, ax = plt.subplots(figsize=(10, 6))
        n = len(h["ema_param_dist"])
        ax.plot(h["epoch"][:n], h["ema_param_dist"], linewidth=2,
                color="purple", label="Param Distance")
        ax.set_xlabel("Epoch")
        ax.set_ylabel("L2 Distance")
        ax.set_title("EMA Model Tracking Distance", fontweight="bold")
        ax.legend()
        ax.grid(True, alpha=0.3)
        fig.tight_layout()
        out = self.log_dir / "ema_distance.png"
        fig.savefig(out, dpi=150)
        plt.close(fig)
        return out

    def plot_dashboard(self) -> Optional[Path]:
        """Combined 3x2 dashboard: loss / accuracy / LR / grad norm / EMA
        distance / best-metrics summary (HQAViT_IN_Tiny.py:360-456)."""
        h = self.history
        if not h["epoch"]:
            return None
        plt = pyplot_or_none("training_dashboard.png")
        if plt is None:
            return None
        fig = plt.figure(figsize=(16, 12))
        gs = fig.add_gridspec(3, 2, hspace=0.3, wspace=0.3)
        ep = h["epoch"]

        def series(ax, specs, title, ylabel, log_y=False):
            for key, label, style in specs:
                if h.get(key):
                    ax.plot(ep[:len(h[key])], h[key], style, label=label,
                            linewidth=2)
            ax.set_xlabel("Epoch")
            ax.set_ylabel(ylabel)
            ax.set_title(title, fontweight="bold")
            if log_y:
                ax.set_yscale("log")
            if specs[0][1]:
                ax.legend()
            ax.grid(True, alpha=0.3)

        series(fig.add_subplot(gs[0, 0]),
               [("train_loss", "Train", "-"), ("val_loss", "Val", "-"),
                ("ema_val_loss", "EMA Val", "--")], "Loss Curves", "Loss")
        series(fig.add_subplot(gs[0, 1]),
               [("train_acc", "Train", "-"), ("val_acc", "Val", "-"),
                ("ema_val_acc", "EMA Val", "--")],
               "Accuracy Curves", "Accuracy (%)")
        series(fig.add_subplot(gs[1, 0]), [("lr", "", "-")],
               "Learning Rate Schedule", "Learning Rate", log_y=True)
        series(fig.add_subplot(gs[1, 1]), [("grad_norm", "", "-")],
               "Gradient Norm", "Gradient Norm")
        series(fig.add_subplot(gs[2, 0]),
               [("ema_param_dist", "Param", "-")],
               "EMA Tracking Distance", "L2 Distance")

        ax6 = fig.add_subplot(gs[2, 1])
        ax6.axis("off")
        lines = []
        if h.get("val_acc"):
            lines.append(f"Best Val Acc: {max(h['val_acc']):.2f}%")
        if h.get("ema_val_acc"):
            lines.append(f"Best EMA Val Acc: {max(h['ema_val_acc']):.2f}%")
        if h.get("val_loss"):
            lines.append(f"Best Val Loss: {min(h['val_loss']):.4f}")
        ax6.text(0.5, 0.5, "\n\n".join(lines), ha="center", va="center",
                 fontsize=14, fontweight="bold", transform=ax6.transAxes)
        ax6.set_title("Best Metrics", fontweight="bold", fontsize=14)

        fig.suptitle("HQA-ViT Training Dashboard", fontsize=16,
                     fontweight="bold", y=0.995)
        out = self.log_dir / "training_dashboard.png"
        fig.savefig(out, dpi=150, bbox_inches="tight")
        plt.close(fig)
        return out

    def plot_transfer_summary(self, pretrained_acc: float,
                              source: str = "pretrain",
                              target: str = "finetune") -> Optional[Path]:
        """Transfer-learning summary figure: accuracy curves vs the
        pretrained baseline + comparison bars with improvement annotations
        (HQAViT_Tiny_Cifar10.py:196-258)."""
        h = self.history
        if not (h.get("val_acc") and h.get("train_acc")):
            return None
        plt = pyplot_or_none("final_summary.png")
        if plt is None:
            return None
        fig, axes = plt.subplots(1, 2, figsize=(16, 6))
        ep = h["epoch"]

        ax1 = axes[0]
        ax1.plot(ep[:len(h["train_acc"])], h["train_acc"], "b-",
                 label="Train Acc", linewidth=2.5, marker="o", markersize=4)
        ax1.plot(ep[:len(h["val_acc"])], h["val_acc"], "r-",
                 label="Val Acc", linewidth=2.5, marker="s", markersize=4)
        ax1.axhline(y=pretrained_acc, color="gray", linestyle="--",
                    linewidth=2, alpha=0.7,
                    label=f"Pretrained ({source}): {pretrained_acc:.2f}%")
        ax1.axhline(y=self.best_val_acc, color="green", linestyle="--",
                    linewidth=2,
                    label=f"Best Val ({target}): {self.best_val_acc:.2f}%")
        ax1.set_xlabel("Epoch", fontweight="bold")
        ax1.set_ylabel("Accuracy (%)", fontweight="bold")
        ax1.set_title(f"Transfer Learning: {source} → {target}",
                      fontweight="bold", fontsize=16)
        ax1.legend(loc="lower right", framealpha=0.9)
        ax1.grid(True, alpha=0.3, linestyle="--")

        ax2 = axes[1]
        cats = [f"Pretrained\n({source})", f"Final Val\n({target})",
                f"Best Val\n({target})"]
        vals = [pretrained_acc, h["val_acc"][-1], self.best_val_acc]
        bars = ax2.bar(cats, vals, color=["gray", "orange", "green"],
                       alpha=0.7, edgecolor="black", linewidth=2, width=0.6)
        for bar, v in zip(bars, vals):
            ax2.text(bar.get_x() + bar.get_width() / 2,
                     bar.get_height() + 0.5, f"{v:.2f}%", ha="center",
                     va="bottom", fontweight="bold")
        for i, color in ((1, "darkred"), (2, "darkgreen")):
            ax2.annotate(f"{vals[i] - vals[0]:+.2f}%", xy=(i, vals[i]),
                         xytext=(i, vals[0] + (vals[i] - vals[0]) / 2),
                         ha="center", color=color, fontweight="bold")
        ax2.set_ylabel("Accuracy (%)", fontweight="bold")
        ax2.set_title("Performance Comparison", fontweight="bold",
                      fontsize=16)
        ax2.set_ylim([min(vals) - 5, max(vals) + 5])
        ax2.grid(True, alpha=0.3, axis="y", linestyle="--")

        fig.tight_layout()
        out = self.log_dir / "final_summary.png"
        fig.savefig(out, dpi=150, bbox_inches="tight")
        plt.close(fig)
        return out
