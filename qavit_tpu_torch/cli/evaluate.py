"""Evaluation entry point of the port: the eval forward of a preset over
its dataset's test split.

    python -m qavit_tpu_torch.cli.evaluate --preset hqavit_proc100_hard \
        [--data-root ./data] [--batch-size 1024] [--batches N] [--device cpu]
    python -m qavit_tpu_torch.cli.evaluate --preset hqavit_c100 \
        --synthetic --seed 0 --batch-size 1024 --batches 4 [--device cpu]

Builds the model at full width from seed-made weights (or from a
``--weights`` file written by ``torch.save(model.state_dict())``) and
runs a two-image smoke forward.  Without ``--synthetic`` it reads the
preset's pipeline (``data/pipelines.py``), loads its base dataset with
``load_dataset(base, --data-root)`` (a procedural substrate is generated
once and cached there as ``<name>.npz``; a reader dataset whose files are
absent gives the JAX package's synthetic fallback), uploads the test
split to the device once and evaluates all of it, sliced on the device
(``--batches`` caps the number of batches), preprocessed by
``eval_batch`` with the pipeline's ``AugConfig`` (the 32 -> 224 resize
of ``cifar100_224`` included).  ``--synthetic`` evaluates ``--batches``
batches (default 4) of a seed-made synthetic test set at the model's
image size instead.  One untimed batch of each batch shape comes first;
then it prints top-1, top-5, loss and images per second (host clock over
the evaluated batches).  Runs on the card unless ``--device cpu`` is
given.  Serves every preset of ``configs/presets.py``: ``hqavit_c100``
and the substrate presets of its geometry (``hqavit_proc100``,
``hqavit_proc100_hard``, ``hqavit_proc100_hard_finetune``,
``hqavit_tiny_proc10``); the depth-12 HQAViT at 64 px
(``hqavit_tiny_in``, ``hqavit_proc_tin``: the fused units at n=64 in four
SWA windows); and the flat 224 QAViTs (``qavit_224_v1``,
``qavit_224_v1_proc``, ``qavit_v2``, ``qavit_v2_proc224``).  Grad-CAM, TTA
and the plots wait for a later slice.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import torch

from qavit_tpu_torch.configs import get_preset
from qavit_tpu_torch.data.augment import eval_batch
from qavit_tpu_torch.data.datasets import load_dataset, synthetic_dataset
from qavit_tpu_torch.data.pipelines import get_pipeline
from qavit_tpu_torch.device import resolve_device
from qavit_tpu_torch.eval.metrics import evaluate
from qavit_tpu_torch.nn.models import build_model
from qavit_tpu_torch.train.steps import make_eval_step


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--preset", required=True)
    p.add_argument("--synthetic", action="store_true",
                   help="evaluate on a seed-made synthetic test set instead "
                        "of the preset's dataset")
    p.add_argument("--data-root", default="./data",
                   help="where the datasets and the generated substrates' "
                        "caches are")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the synthetic data and of the weights")
    p.add_argument("--batch-size", type=int, default=1024)
    p.add_argument("--batches", type=int, default=None,
                   help="evaluate at most this many batches (default: the "
                        "whole test split; 4 with --synthetic)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--weights", default=None,
                   help="a state dict saved with torch.save")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    preset = get_preset(args.preset)
    mc = preset.model
    pipe = get_pipeline(preset.dataset)

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

    bs = args.batch_size
    if args.synthetic:
        n = bs * (4 if args.batches is None else args.batches)
        # only the test split is used: no train split is drawn (at 224 px
        # it would be gigabytes of host memory)
        ds = synthetic_dataset(preset.dataset, mc.img_size, mc.num_classes,
                               n_train=0, n_test=n, seed=args.seed)
    else:
        ds = load_dataset(pipe.base_dataset, args.data_root)
        n = len(ds.test_labels)
        if args.batches is not None:
            n = min(n, bs * args.batches)
        fallback = " (the synthetic fallback)" if ds.synthetic else ""
        print(f"dataset {ds.name}{fallback}: {n} of {len(ds.test_labels)} "
              f"test images under {args.data_root}", flush=True)
    images = torch.from_numpy(ds.test_images[:n]).to(device)
    labels = torch.from_numpy(ds.test_labels[:n]).long().to(device)
    loader = [(images[i:i + bs], labels[i:i + bs]) for i in range(0, n, bs)]

    eval_step = make_eval_step(model)
    prep = lambda im: eval_batch(im, pipe.aug)   # noqa: E731
    # one untimed batch of each shape first: the library picks its
    # convolution plans for a batch shape on first use
    for x, y in {tuple(x.shape): (x, y) for x, y in loader}.values():
        eval_step(prep(x), y)
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
