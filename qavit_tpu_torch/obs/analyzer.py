"""Architecture analysis: the parameter breakdown, the analytic forward
FLOPs and the activation-memory estimate that the trainer prints at
start (counterpart of ``qavit_tpu/obs/analyzer.py:18-147``; the
ArchitectureAnalyzer of QAViTv2.py:104-346).

Parameters are grouped under the JAX package's module paths
(``train/optim.py`` ``jax_path``: a stack's blocks are one group, as
JAX's scanned leaf is), so the breakdown reads as JAX's does.  The
measured harness (``benchmark_fn``, ``batch_size_sweep``,
``device_memory_stats``) waits for ROADMAP.md queue 1 item 11.
"""

from __future__ import annotations

from typing import Dict

import torch.nn as nn

from qavit_tpu_torch.configs.model import ModelConfig
from qavit_tpu_torch.train.optim import jax_path


def param_breakdown(model: nn.Module, depth: int = 1) -> Dict[str, int]:
    """Parameter counts grouped by the first ``depth`` keys of each
    parameter's JAX path, largest first (ties by name)."""
    out: Dict[str, int] = {}
    for name, p in model.named_parameters():
        group = "/".join(jax_path(name).split("/")[:depth])
        out[group] = out.get(group, 0) + p.numel()
    return dict(sorted(out.items(), key=lambda kv: (-kv[1], kv[0])))


def analytic_flops(cfg: ModelConfig, batch: int = 1) -> Dict[str, float]:
    """Analytic forward-FLOPs model per component (QAViTv2.py:235-282
    analogue, extended to the hybrid path)."""
    n = cfg.num_learned_tokens if (cfg.hybrid and cfg.use_token_learner) \
        else cfg.num_patches
    full_n = cfg.num_patches
    c = cfg.embed_dim
    dc = c // cfg.compress_ratio
    s = cfg.bank.size
    k = cfg.linformer_k
    f: Dict[str, float] = {}

    f["patch_embed"] = 2 * full_n * (cfg.patch_size ** 2 * 3) * c

    # per block -----------------------------------------------------------
    ws2 = cfg.window_size ** 2
    n_win = max(n // ws2, 1)
    swa = (2 * n * c * 3 * c                       # qkv
           + 2 * n_win * cfg.num_heads * 2 * ws2 * k * (c // cfg.num_heads)
           + 2 * n * (k + s) * c * 2               # attn
           + 2 * n * c * c)                        # proj
    msda = (2 * n * c * c + 2 * (n // 2) * c * 2 * c
            + 2 * cfg.msda_pad_len * k * c * 2
            + 2 * n * (k + s) * c * 2 + 2 * n * c * c)
    cga = (2 * n * c * (c // 2) * 3 + 2 * n * (n + s) * (c // 2) * 2
           + 2 * n * (c // 2) * c)
    cross = 2 * n * c * c + 2 * s * c * c * 2 + 2 * n * s * c * 2 \
        + 2 * n * c * c
    compress = 4 * 2 * n * c * dc
    bottleneck = 2 * n * 4 * dc * (c // cfg.bottleneck_ratio) \
        + 2 * n * (c // cfg.bottleneck_ratio) * c
    hidden = int(c * cfg.mlp_ratio)
    ffn = 2 * n * c * hidden + 9 * n * hidden * 2 + 2 * n * hidden * c
    block = swa + msda + cga + cross + compress + bottleneck + ffn
    if cfg.hybrid and cfg.use_token_learner:
        block += 2 * full_n * c * n + 2 * n * full_n * c  # learner + upmix
    f["blocks"] = cfg.depth * block

    if cfg.hybrid:
        hw2 = cfg.grid_size ** 2
        stem = 2 * (cfg.img_size // 2) ** 2 * 9 * 3 * 32 \
            + 2 * hw2 * 9 * 32 * cfg.cnn_c2 \
            + 2 * hw2 * (cfg.cnn_c2 * cfg.cnn_c3 + cfg.cnn_c3 * cfg.cnn_c4)
        convnext = sum(2 * hw2 * (49 * ch + 8 * ch * ch)
                       for ch in (cfg.cnn_c2, cfg.cnn_c3, cfg.cnn_c4))
        lmfa = sum(2 * hw2 * (34 * ch + 3 * ch * c)
                   for ch in (cfg.cnn_c2, cfg.cnn_c3, cfg.cnn_c4))
        rrcv = 3 * (2 * hw2 * (c * cfg.rrcv_channels * 2
                               + 49 * cfg.rrcv_channels
                               + 8 * cfg.rrcv_channels ** 2))
        fusion = 3 * (2 * full_n * c * c + 2 * full_n * 2 * c * c)
        f["cnn_stem"] = stem + convnext
        f["lmfa"] = lmfa
        f["rrcv"] = rrcv
        f["split_fusion"] = fusion

    f["head"] = 2 * c * cfg.num_classes
    f["total"] = sum(v for k_, v in f.items() if k_ != "total")
    return {k_: v * batch for k_, v in f.items()}


def memory_breakdown(cfg: ModelConfig, batch: int = 128,
                     act_bytes: int = 2) -> Dict[str, tuple]:
    """Per-component forward activation / gradient memory estimate in MB
    (the _print_memory_analysis analogue, QAViTv2.py:204-233), the JAX
    package's model of it: bf16 activations (``act_bytes=2``) and one
    block's activations live in the backward (the 'remat' row; the port's
    fused units recompute their insides in the backward kernels as JAX's
    do).  An estimate: the card's peak is
    ``torch.cuda.max_memory_allocated``."""
    mb = 1024 ** 2
    b = batch
    n = cfg.num_learned_tokens if (cfg.hybrid and cfg.use_token_learner) \
        else cfg.num_patches
    c = cfg.embed_dim
    img = b * 3 * cfg.img_size ** 2 * 4 / mb
    patches = b * cfg.num_patches * c * act_bytes / mb
    # ~4 live token-tensors per block (x, xn, branch outs, ffn hidden)
    per_block = b * n * c * act_bytes * 4 / mb
    head = b * cfg.num_classes * 4 / mb
    out = {
        "input image": (img, 0.0),
        "patch embeddings": (patches, patches),
        "per block": (per_block, per_block),
        "all blocks (no remat)": (per_block * cfg.depth,
                                  per_block * cfg.depth),
        "all blocks (remat, live)": (per_block, per_block),
        "head": (head, head),
    }
    if cfg.hybrid:
        stem = b * cfg.grid_size ** 2 * (cfg.cnn_c2 + cfg.cnn_c3
                                         + cfg.cnn_c4) * act_bytes / mb
        out["cnn stem + lmfa + rrcv"] = (stem, stem)
    return out


def print_analysis(cfg: ModelConfig, model: nn.Module) -> None:
    total = sum(p.numel() for p in model.parameters())
    print("=" * 70)
    print(f"Architecture Analysis — {cfg.name}")
    print("=" * 70)
    print(f"Total parameters: {total:,}")
    print(f"Parameter memory (fp32): {total * 4 / 1e6:.2f} MB")
    print("\nPer-module parameters:")
    for name, n in param_breakdown(model).items():
        print(f"  {name:<28} {n:>12,}  ({100.0 * n / total:5.1f}%)")
    fl = analytic_flops(cfg)
    print(f"\nAnalytic forward FLOPs (batch 1): {fl['total'] / 1e6:.1f} M")
    for name, v in fl.items():
        if name != "total":
            print(f"  {name:<28} {v / 1e6:>10.1f} M")
    mem = memory_breakdown(cfg)
    print("\nMemory estimate (batch 128, bf16 activations), MB:")
    print(f"  {'component':<28} {'acts':>9} {'grads':>9}")
    for name, (a, g) in mem.items():
        print(f"  {name:<28} {a:>9.2f} {g:>9.2f}")
    live = (mem['all blocks (remat, live)'][0]
            + mem['patch embeddings'][0] + mem['input image'][0]
            + mem.get('cnn stem + lmfa + rrcv', (0, 0))[0])
    print(f"  peak (remat, + fp32 params + opt) ≈ "
          f"{live + total * 4 * 3 / 1024**2:.2f}", flush=True)
