"""Evaluation entry point of the port: the eval forward of a preset,
served batch after batch.

    python -m qavit_tpu_torch.cli.evaluate --preset hqavit_c100 \
        --synthetic --seed 0 --batch-size 1024 --batches 4 [--device cpu]

Builds the model at full width from seed-made weights (or from a
``--weights`` file written by ``torch.save(model.state_dict())``), runs a
two-image smoke forward and one untimed batch, then evaluates
``--batches`` batches of the synthetic test set and prints top-1, top-5,
loss and images per second (host clock over the evaluated batches).
Runs on the card unless ``--device cpu`` is given.  Serves every preset
of ``configs/presets.py``: ``hqavit_c100`` and the flat 224 QAViTs
(``qavit_224_v1``, ``qavit_224_v1_proc``, ``qavit_v2``,
``qavit_v2_proc224``), whose synthetic images are made at 224 px (the
32 -> 224 resize of the ``cifar100_224`` pipeline waits for the data
path, ROADMAP queue 1 item 3).  Grad-CAM, TTA and the plots wait for a
later slice.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import torch

from qavit_tpu_torch.configs import get_preset
from qavit_tpu_torch.data.augment import eval_batch
from qavit_tpu_torch.data.datasets import (PIPELINE_BASE, STATS,
                                           synthetic_dataset)
from qavit_tpu_torch.device import resolve_device
from qavit_tpu_torch.eval.metrics import evaluate
from qavit_tpu_torch.nn.models import build_model
from qavit_tpu_torch.train.steps import make_eval_step


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--preset", required=True)
    p.add_argument("--synthetic", action="store_true",
                   help="evaluate on the seed-made synthetic set (the only "
                        "data source this slice has)")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the synthetic data and of the weights")
    p.add_argument("--batch-size", type=int, default=1024)
    p.add_argument("--batches", type=int, default=4)
    p.add_argument("--device", default="cuda")
    p.add_argument("--weights", default=None,
                   help="a state dict saved with torch.save")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Dict:
    args = parse_args(argv)
    if not args.synthetic:
        raise SystemExit("only --synthetic data is ported so far")
    device = resolve_device(args.device)
    preset = get_preset(args.preset)
    mc = preset.model
    mean, std = STATS[PIPELINE_BASE[preset.dataset]]

    model = build_model(mc, device, seed=args.seed)
    if args.weights:
        model.load_state_dict(torch.load(args.weights, map_location=device))
        print(f"loaded {args.weights}")

    with torch.inference_mode():
        dummy = torch.zeros(2, mc.img_size, mc.img_size, mc.in_channels,
                            device=device)
        logits, _ = model(dummy)
    if tuple(logits.shape) != (2, mc.num_classes):
        raise RuntimeError(f"smoke test failed: logits {tuple(logits.shape)}")
    print("smoke test passed:", tuple(logits.shape), flush=True)

    n = args.batch_size * args.batches
    # only the test split is used: no train split is drawn (at 224 px it
    # would be gigabytes of host memory)
    ds = synthetic_dataset(preset.dataset, mc.img_size, mc.num_classes,
                           n_train=0, n_test=n, seed=args.seed)
    images = torch.from_numpy(ds.test_images).to(device)
    labels = torch.from_numpy(ds.test_labels).long().to(device)
    loader = [(images[i:i + args.batch_size], labels[i:i + args.batch_size])
              for i in range(0, n, args.batch_size)]

    eval_step = make_eval_step(model)
    prep = lambda im: eval_batch(im, mean, std)   # noqa: E731
    # one untimed batch first: the library picks its convolution plans
    # for the batch shape on first use
    eval_step(prep(loader[0][0]), loader[0][1])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    r = evaluate(eval_step, loader, preprocess=prep)
    seconds = time.perf_counter() - t0          # evaluate ends in a sync
    r.update(seconds=seconds, img_per_s=r["count"] / seconds,
             device=str(device))
    print(f"top-1: {r['top1']:.2f}%  top-5: {r['top5']:.2f}%  "
          f"loss: {r['loss']:.4f}  n={r['count']}  "
          f"{r['img_per_s']:.1f} img/s on {device}", flush=True)
    return r


if __name__ == "__main__":
    main()
