"""Evaluation entry point of the port: the eval forward of a preset over
its dataset's test split (counterpart of ``qavit_tpu/cli/evaluate.py``).

    python -m qavit_tpu_torch.cli.evaluate --preset hqavit_proc100_hard \
        [--checkpoint DIR] [--tta] [--out-dir DIR] [--data-root ./data] \
        [--batch-size 1024] [--batches N] [--device cpu]
    python -m qavit_tpu_torch.cli.evaluate --preset hqavit_c100 \
        --synthetic --seed 0 --batch-size 1024 --batches 4 [--device cpu]

Builds the model at full width from seed-made weights, then restores a
port checkpoint (``--checkpoint``, a directory written by
``cli.train`` or ``ckpt/checkpoint.py``: its weights, BatchNorm
statistics and bank count) or a ``--weights`` file written by
``torch.save(model.state_dict())``, and runs a two-image smoke forward.
Without ``--synthetic`` it reads the preset's pipeline
(``data/pipelines.py``), loads its base dataset with
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
the evaluated batches), and the best and worst classes by precision.
``--tta`` adds the reference's five-view test-time augmentation
(``eval/tta.py``) over the same batches and prints ``TTA top-1``.
``--out-dir`` writes the confusion matrix (``.npy``, and ``.png`` where
matplotlib is installed), the classification report and the best and
worst classes (JSON) and the prediction grid (``.png``).  Grad-CAM and
attention rollout (``--gradcam``, ``--rollout``) raise: they wait for
ROADMAP.md queue 1 item 9.  Runs on the card unless ``--device cpu`` is
given.  Serves every preset of ``configs/presets.py``: ``hqavit_c100``
and the substrate presets of its geometry (``hqavit_proc100``,
``hqavit_proc100_hard``, ``hqavit_proc100_hard_finetune``,
``hqavit_tiny_proc10``); the depth-12 HQAViT at 64 px
(``hqavit_tiny_in``, ``hqavit_proc_tin``: the fused units at n=64 in four
SWA windows); the flat 224 QAViTs (``qavit_224_v1``,
``qavit_224_v1_proc``, ``qavit_v2``, ``qavit_v2_proc224``); and the flat
QAViTs at 32 and 64 px (``qavit_v2_c100``, ``qavit_v2_extreme``,
``qavit_v2_extreme_proc100``, ``qavit_v2_extreme_tin``), whose blocks
take the preset's ``attn_impl`` (the branch path): a checkpoint trained
under ``--attn-impl fused_block`` holds the same parameters.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from qavit_tpu_torch.ckpt.checkpoint import restore_train_state, written_flat
from qavit_tpu_torch.configs import get_preset
from qavit_tpu_torch.data.augment import eval_batch
from qavit_tpu_torch.data.datasets import load_dataset, synthetic_dataset
from qavit_tpu_torch.data.pipelines import get_pipeline
from qavit_tpu_torch.device import resolve_device
from qavit_tpu_torch.eval import metrics as EM
from qavit_tpu_torch.eval.tta import make_tta_preprocessors
from qavit_tpu_torch.nn.models import build_model
from qavit_tpu_torch.train.state import create_train_state
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
    p.add_argument("--checkpoint", default=None,
                   help="a port checkpoint directory (state.pt, meta.json)")
    p.add_argument("--tta", action="store_true",
                   help="also the five-view test-time augmentation")
    p.add_argument("--out-dir", default=None,
                   help="write the confusion matrix, the per-class report, "
                        "the best and worst classes and a prediction grid")
    p.add_argument("--gradcam", action="store_true",
                   help="not ported (ROADMAP.md queue 1 item 9)")
    p.add_argument("--rollout", action="store_true",
                   help="not ported (ROADMAP.md queue 1 item 9)")
    return p.parse_args(argv)


def write_analysis(out_dir: Path, r: Dict, num_classes: int,
                   images_u8: np.ndarray) -> None:
    """The confusion matrix, the classification report, the best and
    worst classes and the prediction grid of ``r``'s predictions."""
    out_dir.mkdir(parents=True, exist_ok=True)
    preds, labels = r["logits"].argmax(-1), r["labels"]
    cm = EM.confusion_matrix(preds, labels, num_classes)
    np.save(out_dir / "confusion_matrix.npy", cm)
    EM.plot_confusion_matrix(cm, str(out_dir / "confusion_matrix.png"))
    report = EM.classification_report(preds, labels, num_classes)
    (out_dir / "classification_report.json").write_text(
        json.dumps(report, indent=1))
    best, worst = EM.best_worst_classes(report, 10)
    (out_dir / "best_worst_classes.json").write_text(
        json.dumps({"best": best, "worst": worst}, indent=1))
    EM.visualize_predictions(images_u8[:10], preds[:10], labels[:10],
                             str(out_dir / "predictions.png"))
    print(f"wrote the confusion matrix, the classification report, the "
          f"best and worst classes and the prediction grid to {out_dir}")


def main(argv: Optional[List[str]] = None) -> Dict:
    args = parse_args(argv)
    if args.gradcam or args.rollout:
        raise NotImplementedError("Grad-CAM and attention rollout are not "
                                  "ported yet (ROADMAP.md queue 1 item 9)")
    device = resolve_device(args.device)
    preset = get_preset(args.preset)
    mc = preset.model
    pipe = get_pipeline(preset.dataset)

    model = build_model(mc, device, seed=args.seed)
    if args.weights:
        model.load_state_dict(torch.load(args.weights, map_location=device))
        print(f"loaded {args.weights}")
    if args.checkpoint:
        state, _ = restore_train_state(args.checkpoint, create_train_state(
            model, use_ema=False, flat=written_flat(args.checkpoint)))
        print(f"loaded {args.checkpoint} (step {state.step})")

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
    r = EM.evaluate(eval_step, loader, preprocess=prep, collect_logits=True)
    seconds = time.perf_counter() - t0          # evaluate ends in a sync
    r.update(seconds=seconds, img_per_s=r["count"] / seconds,
             device=str(device))
    print(f"top-1: {r['top1']:.2f}%  top-5: {r['top5']:.2f}%  "
          f"loss: {r['loss']:.4f}  n={r['count']}  "
          f"{r['img_per_s']:.1f} img/s on {device}", flush=True)
    report = EM.classification_report(r["logits"].argmax(-1), r["labels"],
                                      mc.num_classes)
    best, worst = EM.best_worst_classes(report, 10)
    print("best classes:", best[:5])
    print("worst classes:", worst[:5])
    if args.out_dir:
        write_analysis(Path(args.out_dir), r, mc.num_classes,
                       ds.test_images[:n])

    if args.tta:
        preps = make_tta_preprocessors(pipe.aug, seed=args.seed)

        @torch.inference_mode()
        def forward(images):
            return model(images)[0]

        t0 = time.perf_counter()
        tta = EM.validate_tta(forward, [loader] * len(preps), preps)
        r.update(tta_top1=tta["tta_top1"],
                 tta_seconds=time.perf_counter() - t0)
        print(f"TTA top-1: {tta['tta_top1']:.2f}%  n={tta['count']}  "
              f"({len(preps)} views, {r['tta_seconds']:.2f} s)", flush=True)
    return r


if __name__ == "__main__":
    main()
