"""Training entry point of the port.

    python -m qavit_tpu_torch.cli.train --preset hqavit_proc100_hard \
        [--epochs N] [--warmup-epochs N] [--batch-size B] [--data-root DIR] \
        [--checkpoint-dir DIR] [--log-dir DIR] [--resume DIR] \
        [--init-from DIR | --init-from-simclr DIR] [--grad-accum K] \
        [--flat-optimizer] [--debug-grads] [--device cpu]

The JAX trainer's single-card, device-resident path
(``qavit_tpu/cli/train.py`` :161-197, :284-298, :324-455): the preset and
its overrides; the dataset's uint8 train and val splits uploaded to the
device once;
``IndexLoader(n, B, shuffle=True, seed)`` orders each epoch, and each
step gathers its batch on the device, augments it there
(``augment_batch`` under the pipeline's ``AugConfig``, the generator
re-seeded from (seed + 1, step), as JAX folds the step into its key) and
runs the preset's train step (``train/steps.py``: the fused units'
kernels on the card).  The step's metrics stay on the device until a
``print_freq`` boundary.  Each epoch sets the EMA's warmup decay,
evaluates the live and the EMA weights on the val split, logs the
learning rate and the EMA's distance, prints the reference's epoch
summary and a ``[phases]`` line (train, eval and checkpoint seconds, the
bytes saved, on the card the peak device memory so far), writes ``training_metrics.json`` and saves ``best_model``,
``best_model_ema`` and every ``save_freq`` epochs
``checkpoint_epoch_{n}`` (``ckpt/checkpoint.py``).

``--resume DIR`` restores the whole train state and continues at epoch
``step // steps_per_epoch + 1`` and the same history file.  As in JAX,
the loader's ``RandomState(seed)`` starts anew in each process, so a
resumed run's first epoch takes the order of epoch 1 (ROADMAP.md, the
known divergences of the JAX reference).  ``--init-from`` (with
``--drop-head``, ``--init-ema``) starts from another checkpoint's
weights (a ``pos_embed`` of another grid resized bicubically, the 32 ->
96 px transfer), ``--init-from-simclr`` from the backbone of a
``cli.pretrain_simclr`` checkpoint (the head new, no BatchNorm
statistics taken, as JAX's :236-243); ``--retain NAME`` exports a slim ``best_model`` to
``checkpoints_keep/NAME``.  A preset with LR groups (the finetune and
transfer presets) prints JAX's group table at startup (``qavit_tpu/cli/
train.py:244-257``).  ``--grad-accum K`` splits each batch into K
micro-batches, ``--flat-optimizer`` runs AdamW, the clipping and the EMA
on raveled vectors (a checkpoint resumes only under the setting it was
written with), and ``--debug-grads`` keeps the per-layer gradient norms
and prints the top layers at each ``print_freq`` boundary.
The flat QAViT trains too: the 224 presets on the branch path (their
proc224 split, ~1.8 GB as uint8, stays on the device), and the 32 px
presets under ``--attn-impl fused_block`` through the n=64 units
(``--preset qavit_v2_extreme_proc100 --attn-impl fused_block``) and the
64 px one through the n=256 units (``--preset qavit_v2_extreme_tin
--attn-impl fused_block``: 256 tokens in 16 SWA windows, 128 pooled MSDA
rows; bf16 on the card).
``--no-cache`` is accepted and does nothing (JAX's compilation cache),
so JAX's command lines run unchanged.  Flags whose path is not ported
raise before the first step, each naming its ROADMAP.md item.  Runs on
the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from qavit_tpu_torch.ckpt.checkpoint import (CheckpointManager,
                                             load_for_transfer,
                                             restore_train_state,
                                             retain_checkpoint)
from qavit_tpu_torch.configs import get_preset
from qavit_tpu_torch.data.augment import augment_batch, eval_batch
from qavit_tpu_torch.data.datasets import (SIZES, load_dataset,
                                           subsample_per_class,
                                           synthetic_dataset)
from qavit_tpu_torch.data.loader import IndexLoader
from qavit_tpu_torch.data.pipelines import get_pipeline
from qavit_tpu_torch.device import resolve_device
from qavit_tpu_torch.eval.metrics import evaluate
from qavit_tpu_torch.nn.models import build_model
from qavit_tpu_torch.obs.analyzer import print_analysis
from qavit_tpu_torch.obs.metrics import TrainingLogger
from qavit_tpu_torch.obs.monitor import GradientMonitor, leaf_names
from qavit_tpu_torch.train.optim import format_lr_group_table, make_schedule
from qavit_tpu_torch.train.state import (create_train_state, ema_distance,
                                         ema_warmup_decay)
from qavit_tpu_torch.train.steps import (make_eval_step, make_train_step,
                                         step_seed)

RESIDENT_BYTES = 2 << 30     # JAX keeps a dataset of at most 2 GiB on device
AUG_SALT = 0x5EED            # JAX's fold_in(rng, 0x5EED) before the step


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--preset", required=True)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--warmup-epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--base-lr", type=float, default=None)
    p.add_argument("--data-root", default=None)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--log-dir", default=None)
    p.add_argument("--resume", default=None,
                   help="checkpoint dir to resume from (true step resume)")
    p.add_argument("--init-from", default=None,
                   help="checkpoint to start from (head kept when its "
                        "shapes match, see --drop-head)")
    p.add_argument("--init-from-simclr", default=None,
                   help="a cli.pretrain_simclr checkpoint: its backbone "
                        "initialises the model (projection head dropped, "
                        "classifier fresh)")
    p.add_argument("--drop-head", action="store_true",
                   help="with --init-from: always keep the new head")
    p.add_argument("--init-ema", action="store_true",
                   help="with --init-from: start from its EMA weights")
    p.add_argument("--retain", default=None,
                   help="after training, export a slim best_model to "
                        "checkpoints_keep/<name>")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--synthetic", action="store_true",
                   help="train on the seed-made synthetic set of the "
                        "preset's base dataset (2048 / 512 images)")
    p.add_argument("--max-steps-per-epoch", type=int, default=None,
                   help="truncate epochs (smoke runs)")
    p.add_argument("--steps-per-call", type=int, default=1,
                   help="only 1 is ported (ROADMAP.md queue 3 item 2)")
    p.add_argument("--data-placement", default="auto",
                   choices=["auto", "host", "device"],
                   help="the port keeps the dataset on the device; host "
                        "is not ported (ROADMAP.md queue 1 item 3)")
    p.add_argument("--loader", default="auto",
                   choices=["auto", "python", "native"],
                   help="native is not ported (ROADMAP.md queue 1 item 3)")
    p.add_argument("--no-cache", action="store_true",
                   help="accepted for JAX's command lines; does nothing")
    p.add_argument("--debug-grads", action="store_true",
                   help="track per-layer gradient norms in the step and "
                        "print the top layers at print_freq and on "
                        "explosions")
    p.add_argument("--grad-accum", type=int, default=None,
                   help="gradient accumulation micro-steps per update")
    p.add_argument("--attn-impl", default=None,
                   choices=["default", "auto", "xla", "pallas",
                            "fused_block"])
    p.add_argument("--flat-optimizer", action="store_true",
                   help="raveled-vector AdamW, clipping and EMA (the same "
                        "math; resume needs the setting the checkpoint "
                        "was written with)")
    p.add_argument("--labels-per-class", type=int, default=None,
                   help="subsample the train split to the first K images "
                        "of each class")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP.md "
                              f"{item})")


def refuse_unported(args: argparse.Namespace, device: torch.device) -> None:
    """Raise for a flag whose path the port does not have, before any
    data is read or any step runs.  A train step the kernels cannot take
    (a geometry of ROADMAP.md queue 2) or an unknown ``lr_groups`` raises
    in ``make_train_step``, also called before the data is read."""
    if args.steps_per_call > 1:
        _not_ported("--steps-per-call above 1 (steps fused into one "
                    "launch, a CUDA graph here)", "queue 3 item 2")
    if args.data_placement == "host":
        _not_ported("--data-placement host (the host-side batch loader "
                    "path)", "queue 1 item 3")
    if args.loader == "native":
        _not_ported("--loader native (the C++ ring batcher)",
                    "queue 1 item 3")
    if device.type == "cuda" and torch.cuda.device_count() > 1:
        _not_ported(f"training on {torch.cuda.device_count()} cards (one "
                    f"card: set CUDA_VISIBLE_DEVICES)", "queue 1 item 10")


def aug_seed(seed: int, step: int) -> int:
    """The seed of step ``step``'s augmentation draws."""
    return step_seed(seed ^ AUG_SALT, step) & (2 ** 63 - 1)


def main(argv: Optional[List[str]] = None) -> float:
    args = parse_args(argv)
    preset = get_preset(args.preset)
    mc, tc = preset.model, preset.train
    overrides = {key: getattr(args, key)
                 for key in ("epochs", "batch_size", "warmup_epochs",
                             "base_lr", "data_root", "checkpoint_dir",
                             "log_dir", "seed")
                 if getattr(args, key) is not None}
    if args.grad_accum is not None:
        overrides["gradient_accumulation_steps"] = args.grad_accum
    if args.flat_optimizer:
        overrides["flat_optimizer"] = True
    tc = tc.replace(**overrides)
    if args.attn_impl is not None:
        mc = mc.replace(attn_impl="auto" if args.attn_impl == "default"
                        else args.attn_impl)
    device = resolve_device(args.device)
    refuse_unported(args, device)
    # the train step's own refusals, before any data is read
    make_train_step(mc, tc, lambda step: 0.0, debug_grads=args.debug_grads)
    print(f"preset={args.preset} model={mc.name} dataset={preset.dataset}")

    # data ---------------------------------------------------------------
    pipe = get_pipeline(preset.dataset)
    base = pipe.base_dataset
    t_data = time.time()
    if args.synthetic:
        ds = synthetic_dataset(base, *SIZES[base])
    else:
        ds = load_dataset(base, tc.data_root)
    t_data = time.time() - t_data
    if ds.synthetic:
        print("WARNING: dataset files not found -> synthetic data")
    if args.labels_per_class:
        ds = subsample_per_class(ds, args.labels_per_class)
        print(f"label-scarce: {args.labels_per_class}/class -> "
              f"{len(ds.train_images)} train images")
    nbytes = ds.train_images.nbytes + ds.test_images.nbytes
    if nbytes > RESIDENT_BYTES:
        _not_ported(f"a dataset of {nbytes / 2 ** 30:.2f} GiB (over 2 GiB: "
                    f"JAX's host-side loader path)", "queue 1 item 3")
    print(f"data placement: device-resident ({nbytes / 1e6:.0f} MB on "
          f"{device}; read, or generated where missing, in {t_data:.1f} s)",
          flush=True)
    train_x = torch.from_numpy(ds.train_images).to(device)
    train_y = torch.from_numpy(ds.train_labels).long().to(device)
    test_x = torch.from_numpy(ds.test_images).to(device)
    test_y = torch.from_numpy(ds.test_labels).long().to(device)
    batch = tc.batch_size
    eval_bs = tc.eval_batch_size or 2 * batch
    train_loader = IndexLoader(len(train_y), batch, shuffle=True,
                               seed=tc.seed, device=device)
    val_loader = [(test_x[i:i + eval_bs], test_y[i:i + eval_bs])
                  for i in range(0, len(test_y), eval_bs)]
    steps_per_epoch = len(train_loader)
    if args.max_steps_per_epoch:
        steps_per_epoch = min(steps_per_epoch, args.max_steps_per_epoch)

    # model / optimizer ----------------------------------------------------
    model = build_model(mc, device, seed=tc.seed)
    print_analysis(mc, model)
    if args.init_from:
        print(f"transfer init from {args.init_from}")
        load_for_transfer(args.init_from, model,
                          drop_head=True if args.drop_head else "auto",
                          use_ema=args.init_ema)
    elif args.init_from_simclr:
        print(f"SimCLR backbone init from {args.init_from_simclr}")
        load_for_transfer(args.init_from_simclr, model, drop_head=True,
                          simclr=True)
    for line in format_lr_group_table(
            [n for n, _ in model.named_parameters()], tc):
        print(line)
    sched = make_schedule(tc, steps_per_epoch)
    state = create_train_state(model, tc.use_ema, tc.ema_decay,
                               flat=tc.flat_optimizer)
    start_epoch = 1
    if args.resume:
        state, _ = restore_train_state(args.resume, state)
        start_epoch = state.step // max(steps_per_epoch, 1) + 1
        print(f"resumed from {args.resume} at step {state.step} "
              f"(epoch {start_epoch})")
    train_step = make_train_step(mc, tc, sched, debug_grads=args.debug_grads)
    eval_step = make_eval_step(model)
    eval_step_ema = (make_eval_step(model, state, use_ema=True)
                     if tc.use_ema else None)
    prep = lambda images: eval_batch(images, pipe.aug)    # noqa: E731

    logger = TrainingLogger(tc.log_dir, track_ema=tc.use_ema,
                            resume=bool(args.resume))
    monitor = GradientMonitor()
    leaves = leaf_names(state.names)
    ckpts = CheckpointManager(tc.checkpoint_dir, mc, tc, tc.save_freq,
                              resume=bool(args.resume))
    step_rng = tc.seed + 1

    for epoch in range(start_epoch, tc.epochs + 1):
        t_epoch = time.time()
        if tc.use_ema:
            state.ema_decay = ema_warmup_decay(epoch, tc.warmup_epochs,
                                               tc.ema_decay_warmup,
                                               tc.ema_decay)

        # ---- train ----
        # the metrics stay on the device until a print boundary: a sync
        # per step would stall a step that is already host-bound
        pending: List[Dict[str, torch.Tensor]] = []
        totals = {"loss": 0.0, "correct": 0, "seen": 0, "steps": 0,
                  "grad": 0.0}

        def drain():
            if not pending:
                return
            # one copy a drain: the scalars, then each step's per-leaf
            # norms under --debug-grads
            rows = torch.stack([torch.cat([torch.stack([
                m["loss"].float(), m["correct"].float(),
                m["grad_norm"].float(), m["param_norm"].float()]),
                m.get("per_leaf", torch.zeros(0, device=device))])
                for m in pending]).cpu().tolist()
            for row, m in zip(rows, pending):
                loss, correct, grad, pnorm = row[:4]
                totals["loss"] += loss
                totals["correct"] += int(correct)
                totals["seen"] += m["count"]
                totals["steps"] += 1
                totals["grad"] = grad
                per_leaf = (dict(zip(leaves, row[4:])) if "per_leaf" in m
                            else None)
                if monitor.log(grad, pnorm, per_leaf):
                    print(f"!! GRADIENT EXPLOSION at epoch {epoch} "
                          f"(norm {grad:.1f})")
                    for name, norm in monitor.top_layers(10):
                        print(f"     {name}: {norm:.4f}")
            pending.clear()

        for i, idx in enumerate(train_loader):
            if i >= steps_per_epoch:
                break
            gen = torch.Generator(device=device).manual_seed(
                aug_seed(step_rng, state.step))
            images = augment_batch(train_x[idx], pipe.aug, gen)
            m = train_step(state, images, train_y[idx], step_rng)
            pending.append({k: m[k] for k in ("loss", "correct", "count",
                                              "grad_norm", "param_norm",
                                              "per_leaf") if k in m})
            if i % tc.print_freq == 0:
                drain()
                loss = totals["loss"] / max(totals["steps"], 1)
                acc = 100.0 * totals["correct"] / max(totals["seen"], 1)
                print(f"Epoch {epoch:3d} [{i:4d}/{steps_per_epoch:4d}] | "
                      f"Loss: {loss:.4f} | Acc: {acc:6.2f}% | Grad: "
                      f"{totals['grad']:.4f}", flush=True)
                if args.debug_grads and monitor.layer_grad_history:
                    tops = ", ".join(f"{n}={v:.3f}"
                                     for n, v in monitor.top_layers(5))
                    print(f"          top grad layers: {tops}", flush=True)
        drain()
        t_train = time.time() - t_epoch

        # ---- validate ----
        metrics = {"train_loss": totals["loss"] / max(totals["steps"], 1),
                   "train_acc": (100.0 * totals["correct"]
                                 / max(totals["seen"], 1)),
                   "lr": float(sched(state.step)),
                   "grad_norm": totals["grad"]}
        if epoch % tc.eval_freq == 0:
            t0 = time.time()
            r = evaluate(eval_step, val_loader, preprocess=prep)
            metrics.update(val_loss=r["loss"], val_acc=r["top1"])
            ema_val_acc = None
            if tc.use_ema:
                re = evaluate(eval_step_ema, val_loader, preprocess=prep)
                dist, _ = ema_distance(state)
                metrics.update(ema_val_loss=re["loss"],
                               ema_val_acc=re["top1"],
                               ema_param_dist=float(dist))
                ema_val_acc = re["top1"]
            t_eval = time.time() - t0
            metrics["epoch_time"] = time.time() - t_epoch
            logger.log_epoch(epoch, metrics)
            logger.print_epoch_summary(epoch, metrics)
            t0 = time.time()
            saved = ckpts.maybe_save(state, epoch, metrics["val_acc"],
                                     ema_val_acc)
            peak = ("" if device.type != "cuda" else f" | peak "
                    f"{torch.cuda.max_memory_allocated(device) / 2 ** 30:.2f}"
                    " GiB")
            print(f"  [phases] train {t_train:.1f}s | eval {t_eval:.1f}s "
                  f"| ckpt {time.time() - t0:.1f}s "
                  f"({ckpts.bytes_written / 1e6:.1f} MB){peak}")
            if saved["best"]:
                print(f"Best model saved! Val Acc: {ckpts.best_acc:.2f}")
            if saved["best_ema"]:
                print(f"Best EMA model saved! EMA Val Acc: "
                      f"{ckpts.best_ema_acc:.2f}")
            logger.save()

    logger.save()
    logger.plot()
    logger.plot_dashboard()
    logger.plot_ema_distance()
    if args.init_from:
        # the transfer summary against the source checkpoint's accuracy
        meta_f = Path(args.init_from) / "meta.json"
        src = (json.loads(meta_f.read_text()).get("metrics", {})
               if meta_f.exists() else {})
        src_acc = float(src.get("val_acc", src.get("ema_val_acc", 0.0)))
        logger.plot_transfer_summary(src_acc, source="pretrain",
                                     target=preset.dataset)
    print(f"Training complete! Best Val Acc: {ckpts.best_acc:.2f}%",
          flush=True)
    if args.retain and (ckpts.dir / "best_model" / "meta.json").exists():
        dst = f"checkpoints_keep/{args.retain}"
        retain_checkpoint(ckpts.dir / "best_model", dst)
        print(f"retained best_model -> {dst} (slim)")
    return ckpts.best_acc


if __name__ == "__main__":
    main()
