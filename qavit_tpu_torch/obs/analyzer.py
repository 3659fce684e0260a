"""Architecture analysis: the parameter breakdown, the analytic forward
FLOPs and the activation-memory estimate that the trainer prints at
start, and the measured harness (counterpart of
``qavit_tpu/obs/analyzer.py``; the ArchitectureAnalyzer of
QAViTv2.py:104-346 and its benchmark loop, QAViTv2.py:1170-1202).

Parameters are grouped under the JAX package's module paths
(``train/optim.py`` ``jax_path``: a stack's blocks are one group, as
JAX's scanned leaf is), so the breakdown reads as JAX's does.
``benchmark_fn`` times a function with CUDA events on the card and the
host clock on the CPU; ``batch_size_sweep`` goes on past a batch that
runs out of device memory; ``device_memory_stats`` reads
``torch.cuda.memory_stats``.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import torch
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


def _first_tensor(out) -> Optional[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (tuple, list)):
        for o in out:
            t = _first_tensor(o)
            if t is not None:
                return t
    return None


def benchmark_fn(fn: Callable, *args, warmup: int = 3, iters: int = 20,
                 **kw) -> Dict[str, float]:
    """Latency and throughput of ``fn(*args, **kw)``: ``warmup`` untimed
    calls, then ``iters`` timed back to back, by CUDA events where the
    output lies on the card (the torch.cuda.Event timing of
    QAViTv2.py:1170-1179), else by the host clock."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kw)
    t = _first_tensor(out)
    if t is not None and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(iters):
            fn(*args, **kw)
        e1.record()
        torch.cuda.synchronize(t.device)
        dt = e0.elapsed_time(e1) / 1e3 / iters
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args, **kw)
        dt = (time.perf_counter() - t0) / iters
    return {"latency_ms": dt * 1e3, "iters_per_sec": 1.0 / dt}


def batch_size_sweep(make_batch: Callable[[int], tuple], fn: Callable,
                     batch_sizes: List[int]) -> List[Dict[str, float]]:
    """Throughput against batch size; a batch that runs out of device
    memory gives a row with its error and the sweep goes on
    (QAViTv2.py:1196-1202)."""
    rows = []
    for bs in batch_sizes:
        try:
            r = benchmark_fn(fn, *make_batch(bs))
            r["batch_size"] = bs
            r["images_per_sec"] = bs * r["iters_per_sec"]
            rows.append(r)
        except torch.cuda.OutOfMemoryError as e:
            torch.cuda.empty_cache()
            rows.append({"batch_size": bs, "error": str(e)[:200]})
    return rows


def device_memory_stats(device=None) -> Optional[Dict[str, int]]:
    """The card's bytes in use, their peak and its capacity (the VRAM
    statistics), or None without CUDA."""
    if not torch.cuda.is_available():
        return None
    stats = torch.cuda.memory_stats(device)
    return {
        "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
        "bytes_limit": torch.cuda.get_device_properties(
            device or torch.cuda.current_device()).total_memory,
    }
