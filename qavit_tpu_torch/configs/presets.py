"""Presets the port serves (its own copy of ``qavit_tpu/configs/
presets.py``: every preset the JAX package defines)."""

from __future__ import annotations

from dataclasses import dataclass

from qavit_tpu_torch.configs.model import BANK_V1, BankConfig, ModelConfig
from qavit_tpu_torch.configs.training import TrainingConfig


@dataclass(frozen=True)
class Preset:
    model: ModelConfig
    train: TrainingConfig
    dataset: str


def _qavit_224_v1() -> Preset:
    """QAViT v1 @224 (QAViT.py:37-94): plain dwconv/CCFFFN, bank v1."""
    model = ModelConfig(
        name="qavit_224_v1",
        img_size=224, patch_size=16, num_classes=100,
        embed_dim=192, depth=8, num_heads=4,
        window_size=7, dilation_factors=(1, 2, 3), linformer_k=64,
        bank=BANK_V1,
        stabilized_dwconv=False, stabilized_ccfffn=False,
        hybrid=False, use_token_learner=False, stage_blocks=(8,),
    )
    train = TrainingConfig(
        batch_size=64, epochs=200, warmup_epochs=10, base_lr=1e-3,
        min_lr=1e-5, weight_decay=0.05, label_smoothing=0.1,
        max_grad_norm=1.0, subtree_clip_norm=None, use_ema=False,
        use_mixup=False, use_cutmix=False,
    )
    return Preset(model, train, "cifar100_224")


def _qavit_v2() -> Preset:
    """QAViTv2 @224 (QAViTv2.py:1011): stabilised dwconv/CCFFFN, bank v2,
    and the dwconv bias its stabilised form keeps (QAViTv2.py:861)."""
    p = _qavit_224_v1()
    model = p.model.replace(
        name="qavit_v2", bank=BankConfig(),
        stabilized_dwconv=True, stabilized_ccfffn=True, dwconv_bias=True,
    )
    return Preset(model, p.train, "cifar100_224")


def _qavit_224_v1_proc() -> Preset:
    """The v1 224 recipe on the proc224 substrate (QAViT.py:705-752)."""
    p = _qavit_224_v1()
    return Preset(p.model.replace(name="qavit_224_v1_proc"),
                  p.train.replace(batch_size=256), "proc224")


def _qavit_v2_proc224() -> Preset:
    """QAViTv2 @224 (QAViTv2.py:1011 knobs) on the proc224 substrate."""
    p = _qavit_v2()
    return Preset(p.model.replace(name="qavit_v2_proc224"),
                  p.train.replace(batch_size=256), "proc224")


def _qavit_v2_c100() -> Preset:
    """QAViTv2-C100 @32 (QAViTv2_CIFAR100.py:41): the flat model at 64
    tokens, four SWA windows of 16."""
    model = ModelConfig(
        name="qavit_v2_c100",
        img_size=32, patch_size=4, num_classes=100,
        embed_dim=192, depth=8, num_heads=4,
        window_size=4, dilation_factors=(1, 2), linformer_k=32,
        hybrid=False, use_token_learner=False, stage_blocks=(8,),
    )
    train = TrainingConfig(
        batch_size=256, epochs=300, warmup_epochs=20, base_lr=6e-4,
        weight_decay=0.05, label_smoothing=0.1, max_grad_norm=1.0,
        subtree_clip_norm=None, use_ema=False,
        use_mixup=False, use_cutmix=False,
    )
    return Preset(model, train, "cifar100")


def _qavit_v2_extreme() -> Preset:
    """QAViTv2-EXTREME @32 (QAViTV2_EXTREME.py:41,1259): DeiT aug, bf16,
    the per-layer dwconv clip and the single-draw mixup/cutmix split."""
    p = _qavit_v2_c100()
    train = p.train.replace(
        use_mixup=True, use_cutmix=True, mix_style="extreme",
        mixup_alpha=0.2, cutmix_alpha=1.0, mixup_prob=0.8, cutmix_prob=0.2,
        max_grad_norm=1.0, subtree_clip_norm=0.1,
        subtree_clip_keys=("dwconv",),
    )
    return Preset(p.model.replace(name="qavit_v2_extreme"), train,
                  "cifar100_deit")


def _qavit_v2_extreme_tin() -> Preset:
    """QAViTv2-EXTREME at TinyImageNet's shape (64 px, patch 4: 256
    tokens in 16 windows, 200 classes) on the proc_tin substrate."""
    p = _qavit_v2_extreme()
    model = p.model.replace(name="qavit_v2_extreme_tin", img_size=64,
                            num_classes=200)
    return Preset(model, p.train, "proc_tin")


def _qavit_v2_extreme_proc100() -> Preset:
    """The EXTREME recipe on the proc100 substrate (JAX trained it under
    ``--attn-impl fused_block``: the n=64 units)."""
    p = _qavit_v2_extreme()
    return Preset(p.model.replace(name="qavit_v2_extreme_proc100"),
                  p.train, "proc100_deit")


def _hqavit_c100() -> Preset:
    """HQA-ViT CIFAR-100 flagship (HQAViT_CIFAR100.py:43-123)."""
    return Preset(ModelConfig(name="hqavit_c100"), TrainingConfig(),
                  "cifar100_hqa")


def _hqavit_v2_c100() -> Preset:
    """HQAViTv2 (HQAViTv2_CIFAR100.py): the ConvNeXt-Tiny patchify stem
    (no BatchNorm) in place of the conv/BN stem."""
    p = _hqavit_c100()
    return Preset(p.model.replace(name="hqavit_v2_c100",
                                  stem_kind="convnext"), p.train,
                  "cifar100_hqa")


def _hqavit_tiny_in() -> Preset:
    """HQAViT-IN-Tiny @64 (HQAViT_IN_Tiny.py:49-84): depth 12 [2,2,6,2],
    64 learned tokens (the fused units at n=64, four SWA windows), 200
    classes."""
    model = ModelConfig(
        name="hqavit_tiny_in",
        img_size=64, patch_size=4, num_classes=200,
        depth=12, drop_path=0.2, num_learned_tokens=64,
        stage_blocks=(2, 2, 6, 2),
    )
    train = TrainingConfig(batch_size=128, epochs=300, warmup_epochs=15,
                           base_lr=5e-4)
    return Preset(model, train, "tiny_imagenet")


def _hqavit_proc_tin() -> Preset:
    """The depth-12 preset on the proc_tin procedural substrate (64 px,
    200 classes, TinyImageNet-shaped)."""
    p = _hqavit_tiny_in()
    return Preset(p.model.replace(name="hqavit_proc_tin"), p.train,
                  "proc_tin")


def _hqavit_proc100() -> Preset:
    """The flagship recipe on the proc100 procedural substrate."""
    p = _hqavit_c100()
    return Preset(p.model.replace(name="hqavit_proc100"), p.train,
                  "proc100_hqa")


def _hqavit_proc100_hard() -> Preset:
    """The flagship recipe on the shortcut-free proc100_hard substrate
    (per-sample palette, wrong-class distractor, occlusion)."""
    p = _hqavit_c100()
    return Preset(p.model.replace(name="hqavit_proc100_hard"), p.train,
                  "proc100_hard_hqa")


def _hqavit_c100_finetune() -> Preset:
    """The CIFAR-100 finetune (HQAViT_C100_Finetune.py): warm-restart
    schedule, layer-wise LR groups, TTA; from a CIFAR-100 pretrain through
    ``--init-from``."""
    p = _hqavit_c100()
    train = p.train.replace(
        epochs=50, warmup_epochs=3, base_lr=1e-4, schedule="warm_restarts",
        lr_groups="layerwise", mix_prob=0.5,
    )
    return Preset(p.model.replace(name="hqavit_c100_finetune"), train,
                  "cifar100_hqa")


def _hqavit_proc100_hard_finetune() -> Preset:
    """The finetune stage on proc100_hard, from the proc100_hard
    pretrain."""
    p = _hqavit_c100_finetune()
    return Preset(p.model.replace(name="hqavit_proc100_hard_finetune"),
                  p.train, "proc100_hard_hqa")


def _hqavit_tiny_cifar10() -> Preset:
    """The CIFAR-10 transfer (HQAViT_Tiny_Cifar10.py): head of 10
    classes, differential LR, cosine schedule."""
    p = _hqavit_c100()
    model = p.model.replace(name="hqavit_tiny_cifar10", num_classes=10)
    train = p.train.replace(
        epochs=100, warmup_epochs=5, base_lr=5e-5, schedule="cosine",
        lr_groups="differential", head_lr_multiplier=10.0, batch_size=256,
    )
    return Preset(model, train, "cifar10")


def _hqavit_tiny_proc10() -> Preset:
    """The CIFAR-10 transfer recipe on proc10, from a proc100 pretrain."""
    p = _hqavit_tiny_cifar10()
    return Preset(p.model.replace(name="hqavit_tiny_proc10"), p.train,
                  "proc10")


def _hqavit_tiny_stl10() -> Preset:
    """The STL-10 transfer at 96 px (HQAViT_Tiny_stl10.py): 24 x 24
    patches, 10 classes, differential LR; built natively at 96 px (the
    v1 stem's maps land on the 24 x 24 token grid), a 32 px checkpoint's
    position embedding resized bicubically on transfer."""
    p = _hqavit_c100()
    model = p.model.replace(name="hqavit_tiny_stl10", img_size=96,
                            num_classes=10)
    train = p.train.replace(
        epochs=50, warmup_epochs=5, base_lr=5e-5, schedule="cosine",
        lr_groups="differential", head_lr_multiplier=10.0, batch_size=128,
    )
    return Preset(model, train, "stl10")


def _simclr_stl10() -> Preset:
    """The SimCLR pretrain on STL-10's unlabeled split (``cli.pretrain_
    simclr``, which takes its model; its optimizer and schedule are the
    CLI's own)."""
    p = _hqavit_tiny_stl10()
    train = p.train.replace(
        epochs=100, warmup_epochs=5, base_lr=0.0424, schedule="cosine",
        label_smoothing=0.0, use_mixup=False, use_cutmix=False,
        lr_groups=None, use_ema=False, batch_size=256,
    )
    return Preset(p.model.replace(name="simclr_stl10"), train,
                  "stl10_unlabeled")


def _hqavit_tiny_proc_stl() -> Preset:
    """Labeled proc_stl (5k labels at 96 px, 100 classes), from scratch or
    from a SimCLR backbone (``--init-from-simclr``)."""
    p = _hqavit_tiny_stl10()
    model = p.model.replace(name="hqavit_tiny_proc_stl", num_classes=100)
    return Preset(model, p.train.replace(base_lr=2e-4), "proc_stl")


PRESETS = {
    "qavit_224_v1": _qavit_224_v1,
    "qavit_v2": _qavit_v2,
    "qavit_224_v1_proc": _qavit_224_v1_proc,
    "qavit_v2_proc224": _qavit_v2_proc224,
    "qavit_v2_c100": _qavit_v2_c100,
    "qavit_v2_extreme": _qavit_v2_extreme,
    "qavit_v2_extreme_tin": _qavit_v2_extreme_tin,
    "qavit_v2_extreme_proc100": _qavit_v2_extreme_proc100,
    "hqavit_c100": _hqavit_c100,
    "hqavit_v2_c100": _hqavit_v2_c100,
    "hqavit_tiny_in": _hqavit_tiny_in,
    "hqavit_proc_tin": _hqavit_proc_tin,
    "hqavit_proc100": _hqavit_proc100,
    "hqavit_proc100_hard": _hqavit_proc100_hard,
    "hqavit_c100_finetune": _hqavit_c100_finetune,
    "hqavit_proc100_hard_finetune": _hqavit_proc100_hard_finetune,
    "hqavit_tiny_cifar10": _hqavit_tiny_cifar10,
    "hqavit_tiny_proc10": _hqavit_tiny_proc10,
    "hqavit_tiny_stl10": _hqavit_tiny_stl10,
    "hqavit_tiny_proc_stl": _hqavit_tiny_proc_stl,
    "simclr_stl10": _simclr_stl10,
}


def get_preset(name: str) -> Preset:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; available: "
                       f"{sorted(PRESETS)}")
    return PRESETS[name]()
