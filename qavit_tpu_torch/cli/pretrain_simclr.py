"""SimCLR pretraining entry point of the port (counterpart of
``qavit_tpu/cli/pretrain_simclr.py``).

    python -m qavit_tpu_torch.cli.pretrain_simclr \
        [--pipeline proc_stl_unlabeled] [--epochs N] [--batch-size B] \
        [--peak-lr LR] [--warmup-epochs N] [--init-from DIR] \
        [--temperature T] [--data-root DIR] [--log-dir DIR] \
        [--checkpoint-dir DIR] [--synthetic] [--max-steps-per-epoch N] \
        [--seed S] [--device cpu]

The ``simclr_stl10`` preset's model (``train/simclr.py`` ``SimCLRNet``,
weights from ``--seed``, 0 as JAX's fixed keys) trains on the
pipeline's train split, uploaded to the device once.  ``IndexLoader(n,
B, shuffle=True, seed=S)`` orders each epoch; each step gathers its batch
on the device and augments it twice there (``augment_batch`` under the
pipeline's two-view ``AugConfig``, each view's generator seeded from its
own counter, as JAX folds ``2 * step`` and ``2 * step + 1`` into its
key), then takes the SimCLR step on the 2B batch.  The optimizer: the global norm clipped to 1.0,
AdamW with weight decay 1e-6 on every parameter, a linear warmup from
peak / 3 over ``--warmup-epochs`` and a cosine to 1e-6 at the end.  The
peak defaults to 0.0424 on ``stl10_unlabeled`` and 0.005 on the
procedural pools (JAX's r3 sweep: 0.0424 collapses NT-Xent on
``proc_stl``).

It prints JAX's progress line every 50 steps and its epoch line, writes
``training_metrics.json`` (``train_loss``, ``lr`` at the step after the
epoch, ``epoch_time``) and saves ``simclr_epoch_N`` after each epoch,
the checkpoint ``cli.train --init-from-simclr`` reads.  ``--init-from``
continues from such a checkpoint: weights, moments and the optimizer's
count restored, the step (and so the logged schedule) restarted at 0,
while the updates follow the restored count, as in JAX (ROADMAP.md, the
known defects of the JAX reference).  A split over 2 GiB (STL-10's
unlabeled files) needs the host-side loader and raises, naming ROADMAP.md
queue 1 item 3, as ``cli.train`` does.  Runs on the card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

import torch

from qavit_tpu_torch.ckpt.checkpoint import (restore_train_state,
                                             save_train_state)
from qavit_tpu_torch.cli.train import RESIDENT_BYTES
from qavit_tpu_torch.configs import get_preset
from qavit_tpu_torch.data.augment import augment_batch
from qavit_tpu_torch.data.datasets import SIZES, load_dataset, \
    synthetic_dataset
from qavit_tpu_torch.data.loader import IndexLoader
from qavit_tpu_torch.data.pipelines import get_pipeline
from qavit_tpu_torch.device import resolve_device
from qavit_tpu_torch.obs.metrics import TrainingLogger
from qavit_tpu_torch.train.simclr import (build_simclr,
                                          make_simclr_train_step,
                                          simclr_schedule)
from qavit_tpu_torch.train.state import create_train_state
from qavit_tpu_torch.train.steps import step_seed

PIPELINES = ("stl10_unlabeled", "proc_stl_unlabeled", "proc_stl50k_unlabeled")
AUG_SEED = 1                   # JAX's PRNGKey(1) of the views
PRINT_FREQ = 50


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--epochs", type=int, default=7)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--peak-lr", type=float, default=None,
                   help="0.0424 on stl10_unlabeled, 0.005 on the "
                        "procedural pools by default")
    p.add_argument("--warmup-epochs", type=int, default=5)
    p.add_argument("--init-from", default=None,
                   help="continue from a simclr_epoch_N checkpoint "
                        "(weights and moments restored, the schedule's "
                        "step restarted)")
    p.add_argument("--temperature", type=float, default=0.5)
    p.add_argument("--data-root", default="./data")
    p.add_argument("--log-dir", default="./logs_simclr")
    p.add_argument("--checkpoint-dir", default="./checkpoints_simclr")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--pipeline", default="stl10_unlabeled",
                   choices=PIPELINES)
    p.add_argument("--max-steps-per-epoch", type=int, default=None)
    p.add_argument("--seed", type=int, default=0,
                   help="weights, order, views and dropout; JAX fixes 0")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.peak_lr is None:
        args.peak_lr = (0.0424 if args.pipeline == "stl10_unlabeled"
                        else 0.005)
        print(f"peak LR (substrate default): {args.peak_lr}")
    return args


def view_seed(k: int, seed: int = 0) -> int:
    """The generator seed of view ``k`` (2 * step and 2 * step + 1)."""
    return step_seed(AUG_SEED + seed, k) & (2 ** 63 - 1)


def main(argv: Optional[List[str]] = None) -> float:
    """Returns the last epoch's mean NT-Xent."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    mc = get_preset("simclr_stl10").model
    pipe = get_pipeline(args.pipeline)
    base = pipe.base_dataset
    ds = (synthetic_dataset(base, *SIZES[base]) if args.synthetic
          else load_dataset(base, args.data_root))
    if ds.synthetic:
        print("WARNING: synthetic data")
    if ds.train_images.nbytes > RESIDENT_BYTES:
        raise NotImplementedError(
            f"a train split of {ds.train_images.nbytes / 2 ** 30:.2f} GiB "
            f"(over 2 GiB: JAX's host-side loader path) is not ported yet "
            f"(ROADMAP.md queue 1 item 3)")
    train_x = torch.from_numpy(ds.train_images).to(device)
    loader = IndexLoader(len(train_x), args.batch_size, shuffle=True,
                         seed=args.seed, device=device)
    steps_per_epoch = len(loader)
    if args.max_steps_per_epoch:
        steps_per_epoch = min(steps_per_epoch, args.max_steps_per_epoch)

    model = build_simclr(mc, device, seed=args.seed)
    total = max(steps_per_epoch * args.epochs, 2)
    warm = min(steps_per_epoch * args.warmup_epochs, total - 1)
    sched = simclr_schedule(args.peak_lr, warm, total)
    state = create_train_state(model, use_ema=False)
    if args.init_from:
        state, _ = restore_train_state(args.init_from, state)
        state.step = 0                   # the schedule restarts
        print(f"simclr: continuing from {args.init_from}")
    step = make_simclr_train_step(sched, args.temperature)

    logger = TrainingLogger(args.log_dir)
    host_step = 0
    mean = float("nan")
    for epoch in range(1, args.epochs + 1):
        t0 = time.time()
        loss_sum = torch.zeros((), device=device)
        n = 0
        for i, idx in enumerate(loader):
            if i >= steps_per_epoch:
                break
            images = train_x[idx]
            views = [augment_batch(images, pipe.aug, torch.Generator(
                device=device).manual_seed(view_seed(2 * host_step + v, args.seed)))
                for v in (0, 1)]
            host_step += 1
            m = step(state, views[0], views[1], args.seed)
            loss_sum += m["loss"].float()
            n += 1
            if i % PRINT_FREQ == 0:
                print(f"Epoch {epoch} [{i}/{steps_per_epoch}] "
                      f"NT-Xent: {float(loss_sum) / n:.4f} "
                      f"LR: {m['lr']:.4f}", flush=True)
        mean = float(loss_sum) / max(n, 1)
        metrics = {"train_loss": mean, "lr": float(sched(state.step)),
                   "epoch_time": time.time() - t0}
        logger.log_epoch(epoch, metrics)
        logger.save()
        print(f"Epoch {epoch}: NT-Xent {metrics['train_loss']:.4f} "
              f"({metrics['epoch_time']:.0f}s)", flush=True)
        save_train_state(f"{args.checkpoint_dir}/simclr_epoch_{epoch}",
                         state, mc)
    logger.plot()
    print("SimCLR pretrain complete", flush=True)
    return mean


if __name__ == "__main__":
    main()
