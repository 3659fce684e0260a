"""Bring-up verification of the port on a GPU (counterpart of
``qavit_tpu/cli/verify_tpu.py``, the verify_gpu.py the reference meant).

    python -m qavit_tpu_torch.cli.verify_gpu [--preset hqavit_c100] \\
        [--batch-sizes 64,256,1024] [--device cpu]

Four sections, as JAX's:
  1. device check: CUDA, the card's name and count (or the CPU);
  2. the flash kernel (``csrc/flash_attention.cu``) against its plain
     version at JAX's shape, q (4, 64, 48) over k, v (4, 48, 48) in
     float32, as [B, N, H, D] with one head (the kernel takes it: 16-144
     keys, head widths 32-64), max error under JAX's 1e-3;
  3. the batch-size sweep of the eval forward with the gradient of the
     cross-entropy with respect to every parameter (``train=False``, as
     JAX's ``jax.grad`` of its eval forward): on the card the fused units'
     eval-mode backward kernels; ``obs/analyzer.batch_size_sweep`` with
     CUDA events, a batch that runs out of memory recorded and skipped;
     then ``device_memory_stats``;
  4. three train steps of the preset at B=256 (one-cycle schedule over 100
     steps, seed 5), the losses and an img/s estimate from steps 2-3,
then ``VERDICT: PASS`` when the device is there and every loss is
finite, else ``VERDICT: FAIL``.  Weights from seed 0; images ``randn``.
Runs on the card unless ``--device cpu``; returns the verdict.
"""

from __future__ import annotations

import argparse
import math
import time
from typing import List, Optional

import torch

from qavit_tpu_torch.configs import get_preset
from qavit_tpu_torch.device import resolve_device
from qavit_tpu_torch.nn.models import build_model
from qavit_tpu_torch.obs.analyzer import batch_size_sweep, device_memory_stats
from qavit_tpu_torch.train.mix import smoothed_cross_entropy
from qavit_tpu_torch.train.optim import make_schedule
from qavit_tpu_torch.train.state import create_train_state
from qavit_tpu_torch.train.steps import make_train_step

TRAIN_BATCH = 256


def _section(title: str, first: bool = False) -> None:
    print(("" if first else "\n") + "=" * 70)
    print(title)
    print("=" * 70, flush=True)


def flash_check(device: torch.device) -> bool:
    from qavit_tpu_torch.kernels import flash_attention as FA

    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(4, n, 1, 48, generator=gen).to(device)
               for n in (64, 48, 48))
    out = FA.flash_attention(q, k, v)
    err = (out - FA.plain(q, k, v)).abs().max().item()
    ok = err < 1e-3
    where = "kernel" if device.type == "cuda" else "plain version (CPU)"
    print(f"flash {where} max err vs plain: {err:.2e} "
          f"({'OK' if ok else 'FAIL'})", flush=True)
    return ok


def main(argv: Optional[List[str]] = None) -> bool:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--preset", default="hqavit_c100")
    p.add_argument("--batch-sizes", default="64,256,1024")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    _section("1) Device check", first=True)
    device = resolve_device(args.device)
    if device.type == "cuda":
        print(f"device: {torch.cuda.get_device_name(device)}  count: "
              f"{torch.cuda.device_count()}  torch {torch.__version__}  "
              f"CUDA {torch.version.cuda}")
    else:
        print(f"device: {device}  torch {torch.__version__}")
    ok_device = True

    _section("2) Flash-attention kernel check")
    try:
        ok_flash = flash_check(device)
    except (RuntimeError, ValueError) as e:
        print(f"flash kernel unavailable: {e}")
        ok_flash = False

    _section("3) Batch-size sweep (fwd + grad)")
    preset = get_preset(args.preset)
    mc, tc = preset.model, preset.train
    model = build_model(mc, device, seed=0)
    params = [t for t in model.parameters() if t.requires_grad]

    def fwd_bwd(x, y):
        logits, _ = model(x)
        loss = smoothed_cross_entropy(logits, y, mc.num_classes, 0.0).mean()
        # the bank's write projections take no part in an eval forward
        return torch.autograd.grad(loss, params, allow_unused=True)

    def make_batch(bs):
        gen = torch.Generator().manual_seed(1)
        x = torch.randn(bs, mc.img_size, mc.img_size, mc.in_channels,
                        generator=gen).to(device)
        return x, torch.zeros(bs, dtype=torch.long, device=device)

    sizes = [int(s) for s in args.batch_sizes.split(",")]
    for row in batch_size_sweep(make_batch, fwd_bwd, sizes):
        print(row, flush=True)
    mem = device_memory_stats(device) if device.type == "cuda" else None
    if mem:
        print(f"device memory: {mem}")

    _section("4) 3-step training test")
    state = create_train_state(build_model(mc, device, seed=0), tc.use_ema,
                               tc.ema_decay)
    step = make_train_step(mc, tc, make_schedule(tc, 100))
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(TRAIN_BATCH, mc.img_size, mc.img_size, mc.in_channels,
                    generator=gen).to(device)
    y = torch.randint(0, mc.num_classes, (TRAIN_BATCH,),
                      generator=gen).to(device)
    losses, t0 = [], None
    for i in range(3):
        losses.append(float(step(state, x, y, 5)["loss"]))
        if i == 0:
            t0 = time.perf_counter()
    dt = (time.perf_counter() - t0) / 2        # float() synchronised
    print(f"losses: {losses}")
    print(f"throughput estimate: {TRAIN_BATCH / dt:.0f} img/s")
    ok_train = all(math.isfinite(v) for v in losses)

    print("\n" + "=" * 70)
    verdict = ok_device and ok_train
    print(f"VERDICT: {'PASS' if verdict else 'FAIL'} (device={ok_device} "
          f"flash={ok_flash} train={ok_train})", flush=True)
    return verdict


if __name__ == "__main__":
    main()
