"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each between flushed ``[t=...s]`` lines so a cut run shows where
it stopped:

  (a) environment: torch / CUDA versions, the card's name and power limit;
  (b) build: the single nvcc build of qavit_tpu_torch/csrc (cache hit?);
  (c) kernel checks: each fused-block unit kernel against its plain
      PyTorch version at B=256, hqavit_c100 shapes, float32 and bf16,
      seed-made weights and inputs, plus the batch-wide NaN guard;
  (d) the main path: ``qavit_tpu_torch.cli.evaluate`` on hqavit_c100 at
      full width and depth, B=1024, synthetic data from the seed, with
      every launch count set to 0 just before and read just after (each
      kernel must launch 8 times per forward); then the model's logits
      through the kernels against the same model run with the plain
      versions on the card, in bf16 and float32;
  (e) timing with CUDA events: each kernel and its plain version at the
      main path's shapes (B=1024, bf16), against the card's bound.

Prints the kernels' JSON record and the card's name and power limit
before the last line, and ends with
``{"ok": true, "device": {"platform": "gpu", ...}}``.  Any failure raises
and exits non-zero; without CUDA it exits 1 before printing a result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from unittest import mock

T0 = time.perf_counter()
BATCH = 1024             # the main path's batch
CHECK_BATCH = 256        # phase (c)
MAIN_BATCHES = 3         # evaluated batches in phase (d)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"torch.float32": 67e12, "torch.bfloat16": 989e12}
REPLACES = {
    "unit_swa": "qavit_tpu/kernels/fused_kernels.py:75",
    "unit_msda": "qavit_tpu/kernels/fused_kernels.py:82",
    "unit_cga": "qavit_tpu/kernels/fused_kernels.py:88",
    "unit_cross_tail": "qavit_tpu/kernels/fused_kernels.py:96",
}


def say(msg: str) -> None:
    print(f"[t={time.perf_counter() - T0:.1f}s] {msg}", flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def perturbed_block(cfg, g, gen):
    """Seed-made block weights, with LN scales, biases, fusion weights and
    gamma moved off their constant inits so every parameter matters."""
    import torch

    from qavit_tpu_torch.kernels.fused_params import QuadBlockParams
    from qavit_tpu_torch.nn.layers import init_weights

    blk = init_weights(QuadBlockParams(cfg, g), gen)
    with torch.no_grad():
        for name, t in blk.named_parameters():
            if name.endswith(("scale", "fusion_weights", "gamma")):
                t.add_(0.3 * torch.randn(t.shape, generator=gen))
            elif name.endswith("bias"):
                t.add_(0.1 * torch.randn(t.shape, generator=gen))
            else:
                t.mul_(3.0)
    return blk


def unit_calls(K, p, g, dtype, x, bank):
    """{name: (kernel call, plain call)} on one set of unit inputs."""
    bk, bv = bank
    o, xn = K.swa_plain(p, x, bk, bv, g, dtype)
    m = K.msda_plain(p, xn, bk, bv, g, dtype)
    c = K.cga_plain(p, xn, bk, bv, g, dtype)
    ct = (x, xn, o, m, c, bk, bv, g, dtype)
    return {
        "unit_swa": (lambda: K.unit_swa(p, x, bk, bv, g, dtype),
                     lambda: K.swa_plain(p, x, bk, bv, g, dtype)),
        "unit_msda": (lambda: K.unit_msda(p, xn, bk, bv, g, dtype),
                      lambda: K.msda_plain(p, xn, bk, bv, g, dtype)),
        "unit_cga": (lambda: K.unit_cga(p, xn, bk, bv, g, dtype),
                     lambda: K.cga_plain(p, xn, bk, bv, g, dtype)),
        "unit_cross_tail": (lambda: K.unit_cross_tail(p, *ct),
                            lambda: K.cross_tail_plain(p, *ct)),
    }


def worst_error(K, out, ref):
    """(max abs err, max abs err / max|plain|, bound, ok) over a unit's
    outputs; the bound is the stated tolerance times max|plain|."""
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    err = max(K.max_abs_err(o, r) for o, r in zip(outs, refs))
    scale = max(r.float().abs().max().item() for r in refs)
    bound = max(K.TOLERANCE[r.dtype] * r.float().abs().max().item()
                for r in refs)
    ok = all(K.within_tolerance(o, r) for o, r in zip(outs, refs))
    return err, err / scale, bound, ok


def unit_work(name, g, b, dtype_bytes, p):
    """(bytes, flops) the unit must move and compute for batch b: each
    activation read once, each output written once, each parameter the
    unit reads once (float32); matmul FLOPs, with the bank projections
    counted once per batch since every sample shares them."""
    n, c, h, lk, s = g.n, g.c, g.heads, g.lin_k, g.bank_s
    d, kv = c // h, g.lin_k + g.bank_s
    act = b * n * c * dtype_bytes
    bank = 2 * s * c * 4

    def nbytes(tree):
        if isinstance(tree, dict):
            return sum(nbytes(v) for v in tree.values())
        return tree.numel() * 4

    if name == "unit_swa":
        w = nbytes(p["norm1"]) + nbytes({k: p["swa"][k] for k in
                                         ("qkv", "linformer", "proj")})
        per = 2 * n * c * 3 * c + 2 * 2 * lk * n * c + 2 * 2 * h * n * kv * d \
            + 2 * n * c * c
        return act + 2 * act + w + bank, b * per
    if name == "unit_msda":
        pm, keep = p["msda"], g.msda_keep
        w = (nbytes({k: pm[k] for k in ("qkv_kernel", "qkv_bias", "proj")})
             + 2 * keep * lk * 4 + n * keep * 4)
        per = 2 * keep * n * c + 2 * keep * c * 2 * c + 2 * 2 * lk * keep * c \
            + 2 * n * c * c + 2 * 2 * h * n * kv * d + 2 * n * c * c
        return act + act + w + bank, b * per
    if name == "unit_cga":
        pc = p["cga"]
        w = nbytes({k: v for k, v in pc.items() if k != "norm"})
        gw, hd = g.groups * g.cperg, g.cperg // h
        per = 3 * 2 * n * g.groups * (c // g.groups) * g.cperg \
            + 2 * 2 * (g.groups * h) * n * (n + s) * hd + 2 * n * gw * c
        return act + act + w + bank, b * per + 2 * 2 * s * c * g.cperg
    tail = {k: v for k, v in p.items()
            if k not in ("norm1", "swa", "msda", "cga")}
    hb, hc = g.bottleneck_hidden, g.ccf_hidden
    per = 2 * n * c * c + 2 * 2 * h * n * s * d + 2 * n * c * c \
        + 4 * 2 * n * c * g.d_c + 2 * 2 * n * c * hb + 2 * 2 * n * c * hc \
        + 2 * 9 * n * hc
    return 5 * act + act + nbytes(tail) + bank, b * per + 2 * 2 * s * c * c


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def main() -> int:
    import torch

    say("phase (a) environment: start")
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 1
    from qavit_tpu_torch.cli import evaluate
    from qavit_tpu_torch.configs import get_preset
    from qavit_tpu_torch.kernels import build
    from qavit_tpu_torch.kernels import fused_kernels as K
    from qavit_tpu_torch.kernels.fused_ref import make_geom
    from qavit_tpu_torch.nn.layers import param_tree
    from qavit_tpu_torch.nn.models import build_model

    # the plain versions are the reference: full float32 products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"CUDA {torch.version.cuda}  device {kind}  count "
          f"{torch.cuda.device_count()}", flush=True)
    print(f"card: {card}", flush=True)
    say("phase (a) environment: done")

    say("phase (b) build: start")
    kl = build.load()
    K.bind(kl.lib)
    print(f"build: {kl.build_seconds:.1f} s, cache hit {kl.cache_hit}, "
          f"{kl.path.name}", flush=True)
    for line in kl.log.splitlines():
        if "spill" in line and "0 bytes spill stores" not in line:
            print("ptxas:", line.strip(), flush=True)
    say("phase (b) build: done")

    cfg = get_preset("hqavit_c100").model
    g = make_geom(cfg)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    p = param_tree(perturbed_block(cfg, g, gen).to(dev))
    bank = tuple((torch.randn(1, g.bank_s, g.c, generator=gen) * 0.5).to(dev)
                 for _ in range(2))

    say("phase (c) kernel checks: start")
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.randn(CHECK_BATCH, g.n, g.c, generator=gen) * 2).to(
                dev, dtype)
            for name, (kern, plain) in unit_calls(K, p, g, dtype, x,
                                                  bank).items():
                out = kern()
                torch.cuda.synchronize()
                err, rel, bound, ok = worst_error(K, out, plain())
                print(f"check {name:16s} {str(dtype):15s} B={CHECK_BATCH} "
                      f"max_abs_err {err:.3e} (relative to max|plain| "
                      f"{rel:.2e}, tolerance {K.TOLERANCE[dtype]:.2e})  "
                      f"bound {bound:.3e}  {'ok' if ok else 'FAIL'}",
                      flush=True)
                if not ok:
                    raise AssertionError(f"{name} {dtype} disagrees with its "
                                         f"plain version")
        # the NaN guard is batch-wide: one NaN sample zeroes every sample's
        # attention output, so SWA's output is its proj bias everywhere
        x = torch.randn(CHECK_BATCH, g.n, g.c, generator=gen).to(dev)
        x[7, 3, 5] = float("nan")
        out, _ = K.unit_swa(p, x, *bank, g, torch.float32)
        torch.cuda.synchronize()
        if not torch.equal(out, p["swa"]["proj"]["bias"].expand_as(out)):
            raise AssertionError("unit_swa: the NaN guard is not batch-wide")
        print("check NaN guard: batch-wide in unit_swa ok", flush=True)
    say("phase (c) kernel checks: done")

    say("phase (d) main path: start")
    K.reset_launches()
    r = evaluate.main(["--preset", "hqavit_c100", "--synthetic", "--seed",
                       "0", "--batch-size", str(BATCH), "--batches",
                       str(MAIN_BATCHES)])
    launches = dict(K.LAUNCHES)
    forwards = MAIN_BATCHES + 2       # + the smoke and the untimed batch
    print(f"main path: {r['count']} images, top-1 {r['top1']:.2f}%, top-5 "
          f"{r['top5']:.2f}%, loss {r['loss']:.4f}, {r['img_per_s']:.1f} "
          f"img/s (host clock, {forwards} forwards)", flush=True)
    print(f"launches during the main path: {launches}", flush=True)
    for name, n in launches.items():
        if n != cfg.depth * forwards:
            raise AssertionError(f"{name}: {n} launches, expected "
                                 f"{cfg.depth} per forward x {forwards}")
    if not (r["count"] == BATCH * MAIN_BATCHES and r["loss"] == r["loss"]
            and 0.0 <= r["top1"] <= r["top5"] <= 100.0):
        raise AssertionError(f"main path result out of range: {r}")

    from qavit_tpu_torch.data.augment import eval_batch
    from qavit_tpu_torch.data.datasets import STATS, synthetic_dataset

    ds = synthetic_dataset("cifar100_hqa", cfg.img_size, cfg.num_classes,
                           n_test=BATCH, seed=0)
    images = eval_batch(torch.from_numpy(ds.test_images).to(dev),
                        *STATS["cifar100"])
    plain = {"unit_swa": K.swa_plain, "unit_msda": K.msda_plain,
             "unit_cga": K.cga_plain, "unit_cross_tail": K.cross_tail_plain}
    model_tol = {"bfloat16": 2.0 ** -4, "float32": 1e-4}
    for dtype_name in ("bfloat16", "float32"):
        model = build_model(cfg.replace(dtype=dtype_name), dev, seed=0)
        with torch.inference_mode():
            lk, _ = model(images)
            with mock.patch.multiple(K, **plain):
                lp, _ = model(images)
        err = (lk - lp).abs().max().item()
        bound = model_tol[dtype_name] * lp.abs().max().item()
        agree = (lk.argmax(-1) == lp.argmax(-1)).float().mean().item()
        ok = bool(torch.isfinite(lk).all()) and err <= bound
        print(f"logits kernels vs plain, {dtype_name}: max_abs_err "
              f"{err:.3e} tolerance {bound:.3e} (max|logit| "
              f"{lp.abs().max().item():.3e}), top-1 agreement "
              f"{100 * agree:.2f}%  {'ok' if ok else 'FAIL'}", flush=True)
        if not ok or tuple(lk.shape) != (BATCH, cfg.num_classes):
            raise AssertionError(f"{dtype_name} model logits disagree")
        del model
    say("phase (d) main path: done")

    say("phase (e) timing: start")
    model = build_model(cfg, dev, seed=0)
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: model(images), iters=10)
    print(f"eval forward: {fwd_ms:.3f} ms per batch of {BATCH}, "
          f"{1000 * BATCH / fwd_ms:.1f} img/s (CUDA events, bf16)",
          flush=True)
    dtype = torch.bfloat16
    record = []
    with torch.inference_mode():
        x = torch.randn(BATCH, g.n, g.c, generator=gen).to(dev, dtype)
        for name, (kern, plain_fn) in unit_calls(K, p, g, dtype, x,
                                                 bank).items():
            err, _, _, ok = worst_error(K, kern(), plain_fn())
            if not ok:
                raise AssertionError(f"{name} disagrees at B={BATCH}")
            ms = cuda_ms(kern)
            plain_ms = cuda_ms(plain_fn)
            nbytes, flops = unit_work(name, g, BATCH, 2, p)
            t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
            t_ops = 1e3 * flops / PEAK_FLOPS[str(dtype)]
            record.append({
                "name": name, "route": "cuda",
                "source": f"qavit_tpu_torch/csrc/{name}.cu",
                "replaces": REPLACES[name], "launches": launches[name],
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": None})
            print(f"time {name:16s} {ms:.4f} ms  plain {plain_ms:.4f} ms  "
                  f"bound {max(t_bytes, t_ops) * 1e3:.2f} us "
                  f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)",
                  flush=True)
    say("phase (e) timing: done")

    print(card_line(), flush=True)
    print(json.dumps({"kernels": record}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
