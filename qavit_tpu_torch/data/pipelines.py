"""Dataset-pipeline presets: (base dataset, train AugConfig) per reference
trainer (the port's own copy of ``qavit_tpu/data/pipelines.py``, field
for field)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from qavit_tpu_torch.data.augment import AugConfig
from qavit_tpu_torch.data.datasets import STATS


@dataclass(frozen=True)
class PipelineSpec:
    base_dataset: str            # key for load_dataset
    aug: AugConfig
    resize_to: Optional[int] = None   # device-side resize (e.g. 32 -> 224)


def _spec(base, mean_std_key, **kw) -> PipelineSpec:
    mean, std = STATS[mean_std_key]
    spec_aug = AugConfig(mean=mean, std=std, **kw)
    return PipelineSpec(base, spec_aug, resize_to=kw.get("resize_to"))


PIPELINES = {
    # QAViT.py:705-752 — Resize 224 + RandomCrop(224, 28) + HFlip
    "cifar100_224": _spec("cifar100", "cifar100", crop_pad=28,
                          resize_to=224),
    # QAViTv2_CIFAR100 @32 — crop/flip only
    "cifar100": _spec("cifar100", "cifar100", crop_pad=4),
    # QAViTV2_EXTREME.py:1091-1151 — DeiT-style
    "cifar100_deit": _spec("cifar100", "cifar100", crop_pad=4,
                           randaug_ops=2, randaug_magnitude=9,
                           erasing_prob=0.25),
    # HQAViT_CIFAR100.py:1293-1302 — 450-epoch heavy pipeline
    "cifar100_hqa": _spec("cifar100", "cifar100", crop_pad=4,
                          rotation_deg=15.0,
                          jitter=(0.5, 0.5, 0.5, 0.15), jitter_prob=0.9,
                          randaug_ops=3, randaug_magnitude=10,
                          erasing_prob=0.3, erasing_scale=(0.02, 0.4)),
    # HQAViT_Tiny_Cifar10.py:261-324
    "cifar10": _spec("cifar10", "cifar10", crop_pad=4, rotation_deg=15.0,
                     jitter=(0.4, 0.4, 0.4, 0.1), jitter_prob=1.0,
                     randaug_ops=2, randaug_magnitude=11,
                     erasing_prob=0.3),
    # HQAViT_Tiny_stl10.py:160-247
    "stl10": _spec("stl10", "stl10", rrc_scale=(0.6, 1.0),
                   rotation_deg=15.0, jitter=(0.4, 0.4, 0.4, 0.1),
                   jitter_prob=1.0, randaug_ops=2, randaug_magnitude=9,
                   blur_prob=0.25, blur_kernel=3,
                   erasing_prob=0.3, erasing_scale=(0.02, 0.2)),
    # SimCLR two-view pipeline reuses stl10 aug (qavit_tpu/train/simclr.py)
    "stl10_unlabeled": _spec("stl10_unlabeled", "stl10",
                             rrc_scale=(0.2, 1.0),
                             jitter=(0.8, 0.8, 0.8, 0.2), jitter_prob=0.8),
    # no-egress SimCLR substrate: the 96px procedural set under the same
    # two-view aug (see procgen.load_or_generate_proc_stl)
    "proc_stl_unlabeled": _spec("proc_stl", "proc_stl",
                                rrc_scale=(0.2, 1.0),
                                jitter=(0.8, 0.8, 0.8, 0.2),
                                jitter_prob=0.8),
    # the SimCLR winning-regime corpus: 50k unlabeled 96px images (the
    # reference's STL-10 unlabeled split is 100k)
    "proc_stl50k_unlabeled": _spec("proc_stl50k", "proc_stl",
                                   rrc_scale=(0.2, 1.0),
                                   jitter=(0.8, 0.8, 0.8, 0.2),
                                   jitter_prob=0.8),
    # 224px procedural substrate under the reference's 224 recipe aug —
    # RandomCrop(224, pad 28) + HFlip (QAViT.py:705-752); the first
    # pipeline whose geometry reaches the flash-attention dispatch
    # (N=196) in a real training
    "proc224": _spec("proc224", "proc100", crop_pad=28),
    # labeled proc_stl (5k labels, mirroring STL-10's labeled split) under
    # the supervised STL transfer aug — the SimCLR->finetune target
    # (HQAViT_Tiny_stl10.py:160-247 knobs)
    "proc_stl": _spec("proc_stl", "proc_stl", rrc_scale=(0.6, 1.0),
                      rotation_deg=15.0, jitter=(0.4, 0.4, 0.4, 0.1),
                      jitter_prob=1.0, randaug_ops=2, randaug_magnitude=9,
                      blur_prob=0.25, blur_kernel=3,
                      erasing_prob=0.3, erasing_scale=(0.02, 0.2)),
    # HQAViT_IN_Tiny.py:1500-1546 — crop(64, 8), no erasing
    "tiny_imagenet": _spec("tiny_imagenet", "tiny_imagenet", crop_pad=8,
                           rotation_deg=15.0,
                           jitter=(0.4, 0.4, 0.4, 0.1), jitter_prob=1.0,
                           randaug_ops=2, randaug_magnitude=6),
    # 200-class 64px procedural substrate under the TinyImageNet aug
    # knobs (HQAViT_IN_Tiny.py:1500-1546 — crop(64, 8), no erasing)
    "proc_tin": _spec("proc_tin", "proc_tin", crop_pad=8,
                      rotation_deg=15.0,
                      jitter=(0.4, 0.4, 0.4, 0.1), jitter_prob=1.0,
                      randaug_ops=2, randaug_magnitude=6),
    # proc10 transfer target under the CIFAR-10 transfer aug knobs
    # (HQAViT_Tiny_Cifar10.py:261-324)
    "proc10": _spec("proc10", "proc10", crop_pad=4, rotation_deg=15.0,
                    jitter=(0.4, 0.4, 0.4, 0.1), jitter_prob=1.0,
                    randaug_ops=2, randaug_magnitude=11,
                    erasing_prob=0.3),
    # shortcut-free hard substrate under the flagship HQA aug knobs —
    # the non-saturating convergence run
    "proc100_hard_hqa": _spec("proc100_hard", "proc100", crop_pad=4,
                              rotation_deg=15.0,
                              jitter=(0.5, 0.5, 0.5, 0.15),
                              jitter_prob=0.9,
                              randaug_ops=3, randaug_magnitude=10,
                              erasing_prob=0.3,
                              erasing_scale=(0.02, 0.4)),
    # proc100 substrate under the DeiT/EXTREME aug knobs
    # (QAViTV2_EXTREME.py:1091-1151) — lets the pure-QAViT multi-window
    # variant train for real without egress
    "proc100_deit": _spec("proc100", "proc100", crop_pad=4,
                          randaug_ops=2, randaug_magnitude=9,
                          erasing_prob=0.25),
    # procedural fallback dataset under the flagship HQA aug pipeline
    # (same knobs as cifar100_hqa; see data/procgen.py)
    "proc100_hqa": _spec("proc100", "proc100", crop_pad=4,
                         rotation_deg=15.0,
                         jitter=(0.5, 0.5, 0.5, 0.15), jitter_prob=0.9,
                         randaug_ops=3, randaug_magnitude=10,
                         erasing_prob=0.3, erasing_scale=(0.02, 0.4)),
}


def get_pipeline(name: str) -> PipelineSpec:
    if name not in PIPELINES:
        raise KeyError(f"unknown pipeline {name!r}; "
                       f"available: {sorted(PIPELINES)}")
    return PIPELINES[name]
