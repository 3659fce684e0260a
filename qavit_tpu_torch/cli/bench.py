"""Benchmark entry point of the port: the train step (or the eval forward)
of a preset at one or more batch sizes.

    python -m qavit_tpu_torch.cli.bench --preset hqavit_c100 --train \
        --batch-sizes 1024 [--steps 3] [--device cpu]

The counterpart of ``qavit_tpu/cli/bench.py --train`` and of the root
``bench.py`` step: weights from seed 0; images ``randn`` and labels
random, as ``bench.py:69-70`` makes them; the preset's whole train step
(mixup/cutmix, dropout, drop-path, label smoothing, two-level clipping,
one-cycle AdamW, EMA, the bank writes).  One untimed warm-up step, then
``--steps`` timed steps with the train state carried from step to step
(``bench.py:76-84``).  On the card the steps are timed with CUDA events.
Prints one JSON row per batch size: img/s, ms/step, the first and last
timed loss and ``torch.cuda.max_memory_allocated``.  The train-time data
augmentation stays out, as in the JAX bench.  ``obs/analyzer.py``'s
``print_analysis`` (FLOPs and parameter breakdown) is printed by
``cli.train``, not here; its measured harness runs in
``cli.verify_gpu``.  The flat presets
train through the preset's ``attn_impl``: the 224 presets on the branch
path (``--preset qavit_224_v1_proc --train --batch-sizes 256``; with
dropout every attention stays on the plain path, as in JAX), and, like
JAX's bench, the bench has no ``--attn-impl``: the flat n=64 presets
train through the fused units under ``cli.train --attn-impl
fused_block``.  The depth-12 ``hqavit_tiny_in`` and ``hqavit_proc_tin``
train at n=64 (four SWA windows) in bf16 on the card (``--preset
hqavit_proc_tin --train --batch-sizes 128``); float32 there raises before
the first launch.  Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Optional

import torch

from qavit_tpu_torch.configs import get_preset
from qavit_tpu_torch.device import resolve_device
from qavit_tpu_torch.nn.models import build_model
from qavit_tpu_torch.train.optim import make_schedule
from qavit_tpu_torch.train.state import create_train_state
from qavit_tpu_torch.train.steps import check_train_geometry, make_train_step

SEED = 0        # of the weights, the batch and the steps' draws

def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--preset", default="hqavit_c100")
    p.add_argument("--train", action="store_true",
                   help="benchmark the train step instead of the forward")
    p.add_argument("--batch-sizes", default="64,256,1024")
    p.add_argument("--steps", type=int, default=3,
                   help="timed steps per batch size (after one warm-up)")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


class _Timer:
    """CUDA events on the card, the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def __enter__(self):
        if self.cuda:
            self.e0 = torch.cuda.Event(enable_timing=True)
            self.e1 = torch.cuda.Event(enable_timing=True)
            self.e0.record()
        else:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            self.e1.record()
            torch.cuda.synchronize()
            self.ms = self.e0.elapsed_time(self.e1)
        else:
            self.ms = 1e3 * (time.perf_counter() - self.t0)


def bench_batch(args, device: torch.device, bs: int) -> Dict:
    preset = get_preset(args.preset)
    mc, tc = preset.model, preset.train
    model = build_model(mc, device, seed=SEED)
    gen = torch.Generator().manual_seed(SEED + 1)
    images = torch.randn(bs, mc.img_size, mc.img_size, mc.in_channels,
                         generator=gen).to(device)
    labels = torch.randint(0, mc.num_classes, (bs,), generator=gen).to(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    losses = []
    if args.train:
        steps_per_epoch = 50_000 // tc.batch_size
        state = create_train_state(model, tc.use_ema, tc.ema_decay)
        step = make_train_step(mc, tc, make_schedule(tc, steps_per_epoch))
        step(state, images, labels, SEED)          # warm-up
        with _Timer(device) as t:
            for _ in range(args.steps):
                losses.append(step(state, images, labels, SEED)["loss"])
        bank_count = int(state.bank_count)
    else:
        with torch.inference_mode():
            model(images)
            with _Timer(device) as t:
                for _ in range(args.steps):
                    model(images)
        bank_count = 0
    ms = t.ms / args.steps
    row = {"preset": args.preset, "mode": "train" if args.train else "eval",
           "batch": bs, "device": str(device), "steps": args.steps,
           "ms_per_step": ms, "img_per_s": 1e3 * bs / ms,
           "timer": "cuda_events" if device.type == "cuda" else "host_clock"}
    if losses:
        row.update(first_loss=float(losses[0]), last_loss=float(losses[-1]),
                   bank_count=bank_count)
    if device.type == "cuda":
        row["max_memory_allocated"] = torch.cuda.max_memory_allocated(device)
        row["card"] = torch.cuda.get_device_name(device)
    return row


def main(argv: Optional[List[str]] = None) -> List[Dict]:
    args = parse_args(argv)
    if args.train:
        check_train_geometry(get_preset(args.preset).model)
    device = resolve_device(args.device)
    rows = []
    for bs in (int(s) for s in args.batch_sizes.split(",")):
        row = bench_batch(args, device, bs)
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
