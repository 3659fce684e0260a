"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each between flushed ``[t=...s]`` lines so a cut run shows where
it stopped:

  (a) environment: torch / CUDA versions, the card's name and power limit;
  (b) build: the single nvcc build of qavit_tpu_torch/csrc (cache hit?),
      each kernel's registers, static shared memory and spills from
      ptxas, and the tensor-core primitives' self-test (ldmatrix ->
      mma.sync against A @ B, B read with and without .trans);
  (c) kernel checks: each fused-block unit kernel against its plain
      PyTorch version at B=256, hqavit_c100 shapes, float32 and bf16,
      seed-made weights and inputs, plus the batch-wide NaN guard; the
      bf16 SWA, MSDA and cross/tail units, which run on the tensor cores
      (swa_mma_kernel, msda_mma16_kernel, cross_tail_mma_kernel, four
      samples to a tile), also with the guard tripped in one sample and
      with 12 bank rows (SWA and MSDA also at B=255, a short last tile),
      each launch through the tensor-core entry; their registers, spills
      and shared memory;
  (d) the main path: ``qavit_tpu_torch.cli.evaluate`` on hqavit_c100 at
      full width and depth, B=1024, synthetic data from the seed, with
      every launch count set to 0 just before and read just after (each
      kernel must launch 8 times per forward, every SWA, MSDA and
      cross/tail launch through its tensor-core entry); then the model's
      logits through
      the kernels against the same model run with the plain versions on
      the card, in bf16 and float32;
  (e) timing with CUDA events: each kernel and its plain version at the
      main path's shapes (B=1024, bf16), against the card's bound, after
      the tensor-core checks of (c) at B=1024;
  (f) training kernels: each unit's train-mode forward (outputs and bank
      partials) and its backward kernel (gradients) against the plain
      version and autograd through it at B=256, float32 and bf16, with
      dropout 0.1 and drop-path 0.1 masks on, and with the NaN guard
      tripped (the guarded branch passes zero gradient; float32, and bf16
      for the SWA, MSDA and cross/tail units, whose bf16 forward and
      backward kernels run on the tensor cores), and those three units in
      bf16 with 12 bank rows; the backward kernels' registers, spills and
      shared memory;
  (g) the train path: ``qavit_tpu_torch.cli.bench --preset hqavit_c100
      --train --batch-sizes 1024`` with every launch count set to 0 just
      before and read just after (each unit's forward and backward kernel
      8 times per step, the SWA, MSDA and cross/tail forward and backward
      launches all through their tensor-core entries, the bank count +24
      per step);
      then the kernel step
      against the plain step on the card at B=1024 (one block a stage,
      CHECK_DEPTH) from the same weights,
      batch and seeds: the gradients of one step in float32 and in bf16
      (beside the bf16 plain step's own distance from the float32 one),
      and bf16 losses over BF16_STEPS steps;
  (h) at B=1024, bf16, masks on: each unit through the autograd wrapper
      the train path calls, its outputs, bank partials and gradients
      against the plain version and autograd through it; then timing with
      CUDA events: the train step, and each unit's train-mode forward and
      backward kernel against its plain version and its bound (a row
      named by its kernel where it runs on the tensor cores:
      swa_mma_kernel_train, cross_tail_mma_kernel, swa_bwd_mma_kernel,
      ...);
  (i) the flash-attention kernel against its plain version at the 224
      path's MSDA and cross shapes (B=256, the cross keys both contiguous
      and broadcast over the batch with stride 0), at qavit_v2_extreme_tin's
      MSDA shape and at the envelope corner (576 queries, 144 keys, D 64),
      float32 and bf16, with dropout 0 and 0.1 (the same hashed mask); its
      autograd Function's backward (a recompute) against autograd through
      the plain version; then its time at the 224 shapes (bf16) on the
      device (torch.profiler) and per call (CUDA events), the plain
      version's and ``scaled_dot_product_attention``'s, beside the bf16
      tensor-core kernel's registers, spills and shared memory;
  (j) the 224 path: ``qavit_tpu_torch.cli.evaluate --preset
      qavit_224_v1_proc`` at full width and depth, B=256, synthetic data
      from the seed, with every launch count set to 0 just before and read
      just after (16 flash launches per forward, no unit launch); then its
      logits through the kernel against the same model with the plain
      version on the card, bf16 and float32, and its eval forward's time;
  (k) multi-window unit checks: each forward unit kernel against its
      plain version at hqavit_proc_tin's geometry (64 tokens on an 8x8
      grid, four SWA windows, 40 pooled MSDA rows), B=256, float32 and
      bf16, seed-made perturbed weights, then with the NaN guard tripped
      in one sample (float32, and bf16 for the SWA, MSDA and cross/tail
      units), and the three bf16 tensor-core kernels with 12 bank rows;
      their registers, spills and shared memory;
  (l) the multi-window path: ``qavit_tpu_torch.cli.evaluate --preset
      hqavit_proc_tin`` at full width and depth (12 blocks), B=128, with
      every launch count set to 0 just before and read just after (12
      launches of each forward unit per forward, no backward or flash
      launch); its logits through the kernels against the plain versions
      on the card, bf16 and float32; the eval forward's time at B=128 and
      B=1024; each unit kernel's time against its plain version and its
      bound at B=1024, bf16; one forward traced at B=128;
  (m) n=64 training kernels at hqavit_proc_tin's geometry, bf16, B=256,
      dropout 0.1 and drop-path 0.1 masks on: each unit's train-mode
      forward (outputs and bank partials) against its plain version and
      its backward kernel's gradients against autograd through the plain
      version, every launch through its n=64 C entry (qv_unit_*_mma_train64,
      qv_unit_*_bwd_mma64); the same with the NaN guard tripped in one
      sample, with 12 bank rows, and at B=255 (a short last pass); the
      eight kernels' registers, spills and shared memory, and for the
      seven on two-CTA clusters (the four backwards swa_bwd_mma_kernel<4>,
      msda_bwd_mma64_kernel, cga_bwd_mma64_kernel,
      cross_tail_bwd_mma64_kernel; the forwards swa_train64_kernel,
      msda_train64_kernel, cross_tail_train64_kernel) the CTAs resident
      per SM and clusters at once (cudaOccupancy*), then the eight
      kernels' device time at B=128 and B=1024;
  (n) the n=64 train path: ``qavit_tpu_torch.cli.bench --preset
      hqavit_proc_tin --train --batch-sizes 128`` with every launch count
      set to 0 just before and read just after (each of the eight kernels
      12 times per step through its n=64 entry, the bank count +36 per
      step); a float32 step refused before any launch; the bf16 kernel
      step against the float32 and bf16 plain steps on the card (phase
      (g)'s rule, one block a stage) and bf16 losses over BF16_STEPS steps; the step's time at B=128
      and at the largest of 1024, 512 and 256 that fits, with its peak
      memory; each unit through the autograd wrapper at B=128 against the
      plain version, and each n=64 train kernel's time on the device and
      per call against its plain version and bound;
  (o) the data path: proc100_hard cut to DATA_SPLITS (10,000 + 2,000
      images) generated into a temporary root and read back by
      ``load_dataset("proc100_hard")``, the root that phase (p) reuses
      (seconds, shapes, dtypes, label range, class counts,
      the val arrays' sha256, not gated: numpy's vectorised cos may differ
      by an ulp between CPUs); ``augment_batch`` under the
      proc100_hard_hqa pipeline on the card at B=1024 (finite,
      [B, 32, 32, 3], the same generator seed twice bitwise equal, another
      seed different, ``apply_augment`` on the card against the CPU with
      the same drawn parameters within 2e-3; ms per batch by CUDA events
      and the device's part of it by torch.profiler); the
      hqavit_proc100_hard train step in bf16 on the device-resident train
      split through ``IndexLoader`` + ``augment_batch`` at B=1024
      (phases p and q train at the preset's 256), with every launch
      count set to 0 just before (each unit's
      forward and backward kernel 8 times per step through its tensor-core
      entry, the bank count +24 per step, every loss finite; ms per step
      with and without augmentation, augmentation's share, img/s, peak
      memory; at B=1024 one step traced: the device's busy time and idle
      share); ``qavit_tpu_torch.cli.evaluate --preset
      hqavit_proc100_hard`` over the whole (cut) val split (seed
      weights: ~1% top-1; each forward unit 8 launches per forward);
  (p) the train loop on phase (o)'s data: ``qavit_tpu_torch.cli.train
      --preset hqavit_proc100_hard --epochs 2 --max-steps-per-epoch 4``
      into temporary checkpoint and log directories, with every launch
      count set to 0 just before and read just after (each unit's
      forward 8 times per step and per validation forward, live and EMA,
      its backward 8 times per step, all through the tensor-core
      entries), ``training_metrics.json`` with exactly the JAX keys, 2
      finite epochs, ``best_model`` and ``best_model_ema`` with their
      ``meta.json``, the bank count 24 a step; then resume on the card:
      RESUME_STEPS steps uninterrupted twice against half of them,
      ``save_train_state``, ``restore_train_state`` into a freshly built
      state and the other half, the
      same weights and batches, the resumed run's distance from an
      uninterrupted one held to RESUME_FACTOR x the two uninterrupted
      runs' distance + RESUME_SLACK; then ``cli.evaluate --checkpoint
      <best_model> --tta --batches 2`` (a finite TTA top-1; the five
      views' forwards launch each forward unit 8 times); each step's
      seconds;
  (q) the finetune stage on phase (o)'s data from phase (p)'s
      ``best_model``: ``qavit_tpu_torch.cli.train --preset
      hqavit_proc100_hard_finetune --init-from <best_model> --epochs 2
      --max-steps-per-epoch 4 --grad-accum 2 --debug-grads`` with every
      launch count set to 0 just before and read just after (each unit's
      forward and backward 8 x 2 times per step, the forward 8 times per
      validation forward, all through the tensor-core entries; the bank
      count 24 x 2 a step), its printed LR-group table and top grad
      layers, its logged ``lr`` equal to ``make_schedule``'s warm-restart
      value at each epoch's step; then three bf16 steps of
      hqavit_proc100_hard at B=256 from the same weights and batches with
      the flat optimizer and without, the parameters, both moments and
      the EMA held per tensor (FLAT_STEP1 after the first step, where both
      took the same gradients; after the third at most FLAT_FACTOR x the
      distance of a per-tensor run from weights one ulp away); then the
      step's median ms over FLAT_TIMED steps with and without the flat
      optimizer (CUDA events, a finding, no gate);
  (r) the flat QAViT's train step, both routes: route A,
      qavit_v2_extreme_proc100 under ``attn_impl="fused_block"`` (C=192,
      depth 8, n=64 in four SWA windows, bf16, B=256): the kernel step
      against the plain step on the card at CHECK_DEPTH blocks (phase
      (g)'s rule: the bf16 gradients of one step, then bf16 losses over
      BF16_STEPS steps) with every launch count set to 0 just before and
      read just after (each unit's forward and backward kernel once a
      block a step through its n=64
      train entry); then ``qavit_tpu_torch.cli.train --preset
      qavit_v2_extreme_proc100 --attn-impl fused_block --epochs 2
      --max-steps-per-epoch 4`` on a proc100 cut to 2,048 + 1,024 images
      (the launches counted: 8 forwards and backwards a step, 8 eval
      forwards a validation forward, through the n=64 entries), a
      checkpoint every epoch, and ``--resume`` from epoch 1's for epochs
      2-3; route B, ``qavit_tpu_torch.cli.bench --preset
      qavit_224_v1_proc --train --batch-sizes 256`` on the branch path
      (no kernel launch: dropout keeps the attentions plain, as in JAX;
      the bank count +24 a step), its ms a step and peak memory;
  (s) the 96 px STL stage: one ``hqavit_tiny_proc_stl`` train step (96
      px, 576 tokens taken down to 16 learned ones in each block, bf16,
      B=128) and one SimCLR step (``simclr_stl10``'s SimCLRNet, B=64 a
      view, 128 images), each with every launch count set to 0 just before
      and read just after (each n=16 unit's forward and backward kernel 8
      times a step through its tensor-core entry, the bank count +24); each
      step's kernels against the plain versions on the card at
      CHECK_DEPTH (phase (g)'s rule on the gradients; the supervised
      step's bf16 losses over BF16_STEPS steps, the NT-Xent loss within
      BF16_LOSS_TOLERANCE); ``hqavit_v2_c100``'s eval logits (the
      ConvNeXt stem, no BatchNorm) through the kernels against the plain
      versions, bf16 and float32, 8 launches of each forward unit; a 32 px
      checkpoint saved from seed weights and loaded into the 96 px model,
      its ``pos_embed`` (8 x 8 -> 24 x 24, bicubic on the card) against the
      same resize on the CPU within STL_RESIZE_TOLERANCE;
  (t) Grad-CAM and attention rollout through the fused units' eval-mode
      backward: each unit's eval forward under autograd (``_eval_unit``,
      the same eval kernel as an inference forward) and its backward
      kernel in eval mode (no masks, no bank partials) against autograd
      through the plain version at hqavit_c100's geometry (n=16, B=1 and
      B=1024) and hqavit_proc_tin's (n=64, B=1 and B=128), bf16, and each
      eval-mode backward's device time against its bound at both batches;
      then, with every launch count set to 0 just before and read just
      after, ``qavit_tpu_torch.cli.evaluate --preset hqavit_c100
      --synthetic --gradcam --rollout --gradcam-images 4
      --rollout-images 4`` (each forward unit 8 launches a forward, each
      backward 8 a Grad-CAM image, all through the tensor-core entries;
      the PNGs counted); Grad-CAM of 4 images of hqavit_c100, 1 of
      hqavit_proc_tin and 1 of qavit_224_v1_proc (the flash kernel) at full
      width from seed-0 weights, kernels against the plain versions: the
      class equal and the CAM within GRADCAM_FACTOR x the plain path's own
      bf16-vs-float32 CAM distance, ms per image; the rollout of one image
      of hqavit_c100 and of qavit_224_v1_proc; ``cli.verify_gpu
      --batch-sizes 64,256`` printing ``VERDICT: PASS``.

Prints the kernels' JSON record and the card's name and power limit
before the last line, and ends with
``{"ok": true, "device": {"platform": "gpu", ...}}``.  Any failure raises
and exits non-zero; without CUDA it exits 1 before printing a result.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import math
import subprocess
import sys
import tempfile
import time
from unittest import mock

T0 = time.perf_counter()
BATCH = 1024             # the main path's batch
CHECK_BATCH = 256        # phases (c), (f)
MAIN_BATCHES = 3         # evaluated batches in phase (d)
TRAIN_STEPS = 2          # timed train steps in phases (g), (n), (r), after
                         # one warm-up
BF16_STEPS = 2           # phases (g), (n), (r): kernel vs plain bf16 losses
# stated tolerances of the kernel train step against the plain step,
# per parameter tensor, against max|plain gradient| or MODEL_GRAD_FLOOR
# of the model's largest gradient where that is more: a gradient that is
# zero in exact arithmetic (TokenUpMix's bias, which the LayerNorm after
# it ignores; the cross branch's key bias) holds only roundoff.  float32:
# the units' sums in another order than the library's, compounding over
# 8 blocks and into the CNN side path.  bf16: both bf16 steps round every
# activation to bf16 (the kernels keep a unit's intermediates and
# cotangents in float32), which moves some gradients, batch-wide sums with
# cancellation such as CCF-FFN's gamma, by more than their own scale
# (1.12 of it on an H100, B=1024).  So the kernel's bf16 gradient is held
# against the float32 plain step: its distance from it (l2, relative)
# must be at most BF16_GRAD_FACTOR x the bf16 plain step's own distance
# plus BF16_GRAD_SLACK.  On such sums two bf16 steps land up to ~6x apart
# in their distance (H100, B=1024: fusion weights 0.287 for the kernels
# against 0.045 for plain, a gamma 0.319 against 1.12), so the limit
# catches a gradient that is wrong by a large part of its scale (a halved
# VJP in one unit fails it), not a small error: the float32 check and the
# per-unit bf16 checks (phases f, h) hold those.  A leaf whose float32 plain gradient is at most
# ROUNDOFF of the largest is zero in exact arithmetic and left out of the
# bf16 check (the float32 check holds it).  bf16 losses over BF16_STEPS
# steps (few, to keep the smoke under five minutes): at
# init every finite model sits near ln(100), so this limit (sound runs
# read <= 3.5e-5, the bf16 plain step against the float32 one 5.6e-6 at
# the first step) catches a step that diverges, not a wrong gradient
MODEL_GRAD_TOLERANCE = 1e-3
MODEL_GRAD_FLOOR = 1e-2
BF16_GRAD_FACTOR = 4.0
BF16_GRAD_SLACK = 0.25
ROUNDOFF = 1e-5
BF16_LOSS_TOLERANCE = 1e-4
FLAT_PRESET = "qavit_224_v1_proc"
FLAT_BATCH = 256         # phases (i), (j): the 224 path's batch
FLAT_BATCHES = 2         # evaluated batches in phase (j)
# (name, B, Nq, Nkv, H, D, keys broadcast over the batch) of phase (i)
FLASH_SHAPES = (
    ("msda_224", FLAT_BATCH, 196, 80, 4, 48, False),
    ("cross_224", FLAT_BATCH, 196, 16, 4, 48, True),
    ("cross_224_contiguous", FLAT_BATCH, 196, 16, 4, 48, False),
    ("msda_extreme_tin", FLAT_BATCH, 256, 48, 4, 48, False),
    ("envelope", 64, 576, 144, 4, 64, False),
)
TIN_PRESET = "hqavit_proc_tin"
TIN_BATCH = 128          # phase (l): the preset's batch
TIN_BIG_BATCH = 1024     # phase (l): timing
TIN_BATCHES = 2          # evaluated batches in phase (l)
TIN_TRAIN_BIG = (1024, 512, 256)   # phase (n): the largest that fits
DATA_PRESET = "hqavit_proc100_hard"  # phase (o)
# phase (o): augmentation and the train step at B=1024 (the preset's 256,
# which phases p and q train at, left out of it to keep the smoke under 5
# minutes)
DATA_BATCHES = (1024,)
DATA_STEPS = 2                      # phase (o): timed steps after one warm-up
# phase (o): proc100_hard's train and val splits, cut from 50,000 and
# 10,000 to keep the smoke under 5 minutes (the val split is not a
# multiple of DATA_EVAL_BATCH, so phase (o)'s evaluation has a short last
# batch, and phase (p)'s two TTA batches are full ones)
DATA_SPLITS = (10000, 3000)
# the depth of the kernel-vs-plain step checks (phases g, n, r): one
# block a stage (HQAViT) or 4 blocks (the flat QAViT), cut to keep the
# smoke under 5 minutes; the paths they check run at full depth
CHECK_DEPTH = 4
DATA_EVAL_BATCH = 1024              # phase (o): cli.evaluate's batch
AUG_TOLERANCE = 2e-3                # phase (o): card vs CPU, normalised units
LOOP_EPOCHS = 2                     # phase (p): cli.train's epochs
LOOP_STEPS = 4                      # phase (p): steps per epoch
# phase (p): saved and restored halfway (2, to keep the smoke with phase
# (t) near 5 minutes)
RESUME_STEPS = 2
TTA_BATCHES = 2                     # phase (p): cli.evaluate --tta batches
# phase (p): the resumed run's distance from an uninterrupted run may be
# at most RESUME_FACTOR x the two uninterrupted runs' distance from each
# other plus RESUME_SLACK (relative to each tensor's largest |value|):
# zero on a deterministic card; where the kernels' float32 atomics sum in
# another order from run to run, two pairs of runs land apart by a
# similar amount, which the factor 2 allows
RESUME_FACTOR = 2.0
RESUME_SLACK = 1e-6
FT_PRESET = "hqavit_proc100_hard_finetune"   # phase (q)
FT_ACCUM = 2                        # phase (q): --grad-accum
FLAT_STEPS = 3                      # phase (q): steps held flat vs per-tensor
FLAT_TIMED = 3                      # phase (q): timed steps each way
FLAT64_PRESET = "qavit_v2_extreme_proc100"   # phase (r), route A
FLAT64_BATCH = 256                  # phase (r): route A's batch (the preset's)
FLAT64_SPLITS = (2048, 1024)        # phase (r): proc100 cut for cli.train
FLAT64_STEPS = 4                    # phase (r): cli.train's steps per epoch
FLAT224_BATCH = 256                 # phase (r), route B: the preset's batch
STL_PRESET = "hqavit_tiny_proc_stl"          # phase (s)
STL_BATCH = 128                     # phase (s): the preset's batch
SIMCLR_BATCH = 64                   # phase (s): images a view (128 a step)
V2_BATCH = 256                      # phase (s): hqavit_v2_c100's eval batch
GRADCAM_IMAGES = {"hqavit_c100": 4, TIN_PRESET: 1, FLAT_PRESET: 1}  # (t)
# phase (t): a Grad-CAM through the kernels may be at most GRADCAM_FACTOR x
# the plain path's own bf16-vs-float32 CAM distance from the plain bf16 one
GRADCAM_FACTOR = 2.0
EVAL_VJP_BATCHES = {16: (1, BATCH), 64: (1, TIN_BATCH)}           # (t)
INTERP_EVAL_BATCH = 256             # phase (t): cli.evaluate's batch
VERIFY_BATCHES = "64,256"           # phase (t): cli.verify_gpu's sweep
# phase (s): the resized pos_embed on the card against the CPU's, relative
# to its largest |value| (two float32 matmuls in another order)
STL_RESIZE_TOLERANCE = 1e-5
# phase (q): the flat optimizer against the per-tensor one, from the same
# weights and batches.  Distances are per tensor, of the parameters,
# Adam's two moments and the EMA, each relative to the larger of its
# tensor's max and FLAT_FLOOR x the largest of its kind in the model (a
# leaf whose gradient is zero in exact arithmetic holds only roundoff).
# After the first step both runs took the same gradients (the n=16 path
# is deterministic on the card): only the order of the norms' sums (an
# ulp or so of the clip scales) and the updates' rounding (an ulp or two
# of each value) separate them, so the distance may be FLAT_STEP1 (~100
# float32 ulps).  From the second step on the parameters
# differ by such ulps, which flip some bf16 roundings of the forward and
# so move the gradients by far more; after FLAT_STEPS steps the distance
# may be FLAT_FACTOR x the larger distance of two per-tensor runs whose
# starting weights were moved by one float32 ulp each, up and down, the
# same kind of perturbation (larger: every weight moves), plus FLAT_STEP1.
# Both distances are set by leaves whose gradient is bf16 roundoff (the
# TokenUpMix bias before its LayerNorm: 0.96 flat, 0.91 one ulp away on
# an H100), where two runs land anywhere within their own scale; the
# factor leaves room for that spread and still fails a run that diverges
FLAT_FLOOR = 1e-2
FLAT_STEP1 = 1e-5
FLAT_FACTOR = 4.0
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"torch.float32": 67e12, "torch.bfloat16": 989e12}
REPLACES = {
    "unit_swa": "qavit_tpu/kernels/fused_kernels.py:75",
    "unit_msda": "qavit_tpu/kernels/fused_kernels.py:82",
    "unit_cga": "qavit_tpu/kernels/fused_kernels.py:88",
    "unit_cross_tail": "qavit_tpu/kernels/fused_kernels.py:96",
}
for _u, _line in (("swa", 75), ("msda", 82), ("cga", 88), ("cross_tail", 96)):
    REPLACES[f"unit_{_u}_bwd"] = (f"qavit_tpu/kernels/fused_pallas.py:244 "
                                  f"(core {_u}, fused_kernels.py:{_line})")
REPLACES["flash_attention"] = ("qavit_tpu/kernels/flash_attention.py:74 "
                               "(pallas_call :122)")


def say(msg: str) -> None:
    print(f"[t={time.perf_counter() - T0:.1f}s] {msg}", flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def ptxas_summary(log: str):
    """One line per kernel entry of nvcc's -Xptxas=-v log: registers,
    static shared memory, stack frame and spills (a template's integer
    arguments in angle brackets)."""
    import re

    name, frame = None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            raw = m.group(1)
            kern = re.search(r"qv\d+(\w+?_kernel)", raw)
            ints = re.findall(r"L[ib](\d+)E", raw)
            name = (kern.group(1) if kern else raw) + (
                f"<{','.join(ints)}>" if ints else "") + (
                "<bf16>" if "bf16" in raw or "13__nv_bfloat16" in raw
                else "")
            continue
        if name and "stack frame" in line:
            frame = line.split(":")[-1].strip()
        m = re.search(r"Used (\d+) registers(.*)", line)
        if name and m:
            yield f"{name}: {m.group(1)} registers{m.group(2)}, {frame}"
            name, frame = None, ""


def print_ptxas(prefix: str) -> None:
    """The ptxas lines of the kernels whose name starts with ``prefix``."""
    from qavit_tpu_torch.kernels import build

    for line in ptxas_summary(build.load().log):
        if line.startswith(prefix):
            print("ptxas:", line, flush=True)


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
    counted once per batch since every sample shares them.  SWA's
    Linformer and attention are per window (nw windows of ws2 tokens,
    nw * ws2 = n), so their per-sample counts are those of n tokens."""
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
        # each pooled row averages pool_stride gathered rows
        pm, keep = p["msda"], g.msda_keep
        w = (nbytes({k: pm[k] for k in ("qkv_kernel", "qkv_bias", "proj")})
             + 2 * keep * lk * 4 + n * keep * 4)
        per = 2 * keep * g.pool_stride * c + 2 * keep * c * 2 * c \
            + 2 * 2 * lk * keep * c + 2 * n * c * c + 2 * 2 * h * n * kv * d \
            + 2 * n * c * c
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


def unit_bwd_work(name, g, b, dtype_bytes, p):
    """(bytes, flops) of a unit's backward: its inputs and the output
    cotangents read once, the input cotangents written once (working
    type), the weights read once and their gradients written once
    (float32); the FLOPs are the recompute plus the two backward products
    of every forward product (3 x the forward's)."""
    nbytes, flops = unit_work(name, g, b, dtype_bytes, p)
    act = b * g.n * g.c * dtype_bytes
    n_in, n_out = {"unit_swa": (1, 2), "unit_msda": (1, 1),
                   "unit_cga": (1, 1), "unit_cross_tail": (5, 1)}[name]
    acts = n_in + n_out
    weights = nbytes - acts * act          # weights + bank, float32
    return (n_in * act + n_out * act + n_in * act + 2 * weights), 3 * flops


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


def bank_write_params(cfg, g, gen, dev):
    from qavit_tpu_torch.nn.bank import GlobalBankParams
    from qavit_tpu_torch.nn.layers import init_weights

    bank = init_weights(GlobalBankParams(cfg.bank, g.c), gen).to(dev)
    return {k: v.detach() for k, v in bank.write_params().items()}


def backward_checks(K, cfg, g, p, dev):
    """Phase (f): every unit's train forward and backward kernel against
    the plain version and autograd, float32 and bf16, masks on; then the
    NaN guard tripped in each unit."""
    import torch

    from qavit_tpu_torch.kernels import build
    from qavit_tpu_torch.kernels import fused_ref as R
    from qavit_tpu_torch.kernels import unit_checks as UC

    gen = torch.Generator().manual_seed(3)
    bankp = bank_write_params(cfg, g, gen, dev)
    rows = tuple((torch.randn(1, g.bank_s, g.c, generator=gen) * 0.5).to(dev)
                 for _ in range(2))
    lib = K.bind(build.load().lib)
    stream = torch.cuda.current_stream().cuda_stream
    grid = K.train_grid(dev, CHECK_BATCH)
    train = K.UnitTrain(R.block_rng(7, 0.1, 0.1), bankp)
    failed = []
    for dtype in (torch.float32, torch.bfloat16):
        x = (torch.randn(CHECK_BATCH, g.n, g.c, generator=gen) * 2).to(
            dev, dtype)
        inputs = UC.unit_inputs(p, g, dtype, x, rows)
        for unit in K.UNITS:
            cots = UC.random_cotangents(unit, inputs[unit], dtype, gen)
            r = UC.check_unit(lib, unit, p, train, inputs[unit], g, dtype,
                              grid, cots, stream)
            print(f"check {unit}_bwd {str(dtype):15s} B={CHECK_BATCH} "
                  f"outputs {r.out_err:.2e} (tolerance "
                  f"{K.TOLERANCE[dtype]:.2e}), partials {r.part_err:.2e} "
                  f"({UC.PARTIAL_TOLERANCE:.0e}), gradients max_abs_err "
                  f"{r.grad_abs:.3e}, relative {r.grad_err:.2e} (tolerance "
                  f"{K.GRAD_TOLERANCE[dtype]:.2e})  "
                  f"{'ok' if r.ok else 'FAIL'}", flush=True)
            if not r.ok:
                failed.append((unit, str(dtype)))
    x = (torch.randn(CHECK_BATCH, g.n, g.c, generator=gen) * 2).to(dev)
    inputs = UC.unit_inputs(p, g, torch.float32, x, rows)
    for unit in K.UNITS:
        batch = list(inputs[unit])
        lead = 1 if unit == "unit_cross_tail" else 0
        batch[lead] = batch[lead].clone()
        batch[lead][CHECK_BATCH // 2, 3, 5] = float("nan")
        cots = UC.random_cotangents(unit, batch, torch.float32, gen)
        r = UC.check_unit(lib, unit, p, train, batch, g, torch.float32, grid,
                          cots, stream, guard_tripped=True)
        print(f"check {unit}_bwd NaN guard: flag {r.flag}, zero bank "
              f"gradient, gradients relative {r.grad_err:.2e} against the "
              f"zero-attention plain version  {'ok' if r.ok else 'FAIL'}",
              flush=True)
        if not r.ok:
            failed.append((unit, "guard"))
    failed += mma_backward_checks(K, g, p, dev, lib, stream, grid, train,
                                  rows, gen)
    if failed:
        raise AssertionError(f"training kernels disagree: {failed}")


# bf16 tensor-core backwards
MMA_BWD = ("unit_swa", "unit_msda", "unit_cga", "unit_cross_tail")


def twelve_bank_rows(K, g, rows, train):
    """The geometry, bank rows and write projections of a 12-row bank
    (the first 12 rows and gate columns)."""
    bank12 = dict(train.bankp)
    bank12["write_gate_kernel"] = bank12["write_gate_kernel"][:, :12].clone()
    bank12["write_gate_bias"] = bank12["write_gate_bias"][:12].clone()
    return (g._replace(bank_s=12),
            tuple(t[:, :12].contiguous() for t in rows),
            K.UnitTrain(train.rng, bank12))


def mma_backward_checks(K, g, p, dev, lib, stream, grid, train, rows, gen):
    """Phase (f), the bf16 tensor-core forward and backward kernels: the
    NaN guard tripped in one sample, and 12 bank rows (the keys past them
    masked); each launch must take the tensor-core entry, forward and
    backward.  Then the backward kernels' ptxas lines and shared memory.
    Returns the failed (unit, case) pairs."""
    import torch

    from qavit_tpu_torch.kernels import unit_checks as UC

    dtype, failed = torch.bfloat16, []
    x = (torch.randn(CHECK_BATCH, g.n, g.c, generator=gen) * 2).to(dev,
                                                                   dtype)
    g12, rows12, train12 = twelve_bank_rows(K, g, rows, train)
    for case in ("NaN guard", "12 bank rows"):
        twelve = case == "12 bank rows"
        gc, rc = (g12, rows12) if twelve else (g, rows)
        inputs = UC.unit_inputs(p, gc, dtype, x, rc)
        for unit in MMA_BWD:
            batch = list(inputs[unit])
            if not twelve:
                lead = 1 if unit == "unit_cross_tail" else 0
                batch[lead] = batch[lead].clone()
                batch[lead][CHECK_BATCH // 2, 3, 5] = float("nan")
            cots = UC.random_cotangents(unit, batch, dtype, gen)
            K.reset_launches()
            r = UC.check_unit(lib, unit, p, train12 if twelve else train,
                              batch, gc, dtype, grid, cots, stream,
                              guard_tripped=not twelve)
            routed = (K.ROUTES[f"{unit}_bwd_mma"] == 1
                      and K.ROUTES[f"{unit}_mma"] == 1)
            ok = r.ok and routed
            print(f"check {unit}_bwd bf16 {case} (tensor-core entry "
                  f"{routed}): flag {r.flag}, outputs {r.out_err:.2e}, "
                  f"gradients max_abs_err {r.grad_abs:.3e}, relative "
                  f"{r.grad_err:.2e} (tolerance "
                  f"{K.GRAD_TOLERANCE[dtype]:.2e})  {'ok' if ok else 'FAIL'}",
                  flush=True)
            if not ok:
                failed.append((unit, f"bf16 {case}"))
    for unit in MMA_BWD:
        kern = f"{unit[5:]}_bwd_mma_kernel"
        print_ptxas(kern)
        smem = getattr(lib, f"qv_{unit}_bwd_mma_smem")(None)
        print(f"{kern}: {smem} B of dynamic shared memory per block",
              flush=True)
    return failed


def train_path(K, cfg):
    """Phase (g): the bench CLI's train steps with the counts reset just
    before; then the kernel step against the plain step on the card."""
    import torch

    from qavit_tpu_torch.cli import bench

    reset_launches()
    row = bench.main(["--preset", "hqavit_c100", "--train", "--batch-sizes",
                      str(BATCH), "--steps", str(TRAIN_STEPS)])[0]
    launches = launch_counts()
    steps = TRAIN_STEPS + 1
    print(f"train path: {steps} steps at B={BATCH}, losses "
          f"{row['first_loss']:.4f} -> {row['last_loss']:.4f}, bank count "
          f"{row['bank_count']}, launches {launches}", flush=True)
    for name, n in launches.items():
        want = 0 if name == "flash_attention" else cfg.depth * steps
        if n != want:
            raise AssertionError(f"{name}: {n} launches in the train path, "
                                 f"expected {want}")
    routes = dict(K.ROUTES)
    print(f"train path: launches per C entry {routes}", flush=True)
    # the bf16 step's forwards and backwards on the tensor cores
    for entry in [f"{u}_bwd" for u in MMA_BWD] + list(MMA_BWD):
        if (routes[f"{entry}_mma"], routes[entry]) != (cfg.depth * steps, 0):
            raise AssertionError(
                f"{entry}: {routes[f'{entry}_mma']} launches of the "
                f"tensor-core entry and {routes[entry]} of the CUDA-core "
                f"one, expected {cfg.depth * steps} and 0")
    if row["bank_count"] != 24 * steps:
        raise AssertionError(f"bank count {row['bank_count']} after {steps} "
                             f"steps, expected 24 per step")
    if not all(map(math.isfinite, (row["first_loss"], row["last_loss"]))):
        raise AssertionError(f"train losses not finite: {row}")
    kernel_vs_plain_step(K, cfg, torch.device("cuda"))
    return launches, row


def grad_errors(got, ref, norm: str = "max"):
    """[(error / scale, error, name)] per parameter, worst first.  "max":
    max|got - ref| against max|ref|; "l2": ||got - ref|| against ||ref||;
    either scale at least that of a tensor filled with MODEL_GRAD_FLOOR
    of the largest |ref| gradient."""
    top = max(t.float().abs().max().item() for t in ref.values())
    errs = []
    for name, r in ref.items():
        r, d = r.float(), got[name].float() - r.float()
        if norm == "max":
            err, scale = d.abs().max().item(), r.abs().max().item()
            floor = MODEL_GRAD_FLOOR * top
        else:
            err, scale = d.norm().item(), r.norm().item()
            floor = MODEL_GRAD_FLOOR * top * math.sqrt(r.numel())
        scale = max(scale, floor)
        errs.append((err / scale if math.isfinite(err) else math.inf, err,
                     name))
    return sorted(errs, reverse=True)


def check_depth(cfg):
    """``cfg`` with its depth cut for the kernel-vs-plain checks: one block
    a non-empty stage (HQAViT), or CHECK_DEPTH blocks (the flat QAViT)."""
    if cfg.hybrid:
        blocks = tuple(min(b, 1) for b in cfg.stage_blocks)
        return cfg.replace(depth=sum(blocks), stage_blocks=blocks)
    depth = min(cfg.depth, CHECK_DEPTH)
    return cfg.replace(depth=depth, stage_blocks=(depth,))


def check_step_grads(grads, f32_kernels, what):
    """Phase (g)'s rule on one step's gradients, ``grads[dtype, mode] =
    (loss, {name: gradient})``: the float32 kernel gradients (where the
    kernels train in float32) within MODEL_GRAD_TOLERANCE of the plain
    ones, and per parameter the bf16 kernel gradients' l2 distance from
    the float32 plain ones at most BF16_GRAD_FACTOR x the bf16 plain
    step's own distance + BF16_GRAD_SLACK (leaves whose float32 plain
    gradient is roundoff left out)."""
    lp32, gp32 = grads["float32", "plain"]
    (l16, g16), (lp16, gp16) = grads["bfloat16", "kernel"], grads[
        "bfloat16", "plain"]
    top = max(t.abs().max().item() for t in gp32.values())
    zero = sorted(n for n, t in gp32.items()
                  if t.abs().max().item() <= ROUNDOFF * top)
    print(f"{len(zero)} of {len(gp32)} parameters have a float32 gradient "
          f"<= {ROUNDOFF:.0e} of the largest ({top:.3e}), left out of the "
          f"bf16 check: {zero[:6]}{' ...' if len(zero) > 6 else ''}",
          flush=True)
    for name in zero:
        del g16[name], gp16[name]
    if f32_kernels:
        l32, g32 = grads["float32", "kernel"]
        errs = grad_errors(g32, gp32)
        ok = errs[0][0] <= MODEL_GRAD_TOLERANCE and math.isfinite(l32)
        print(f"train step float32 kernels vs plain, {what}: loss "
              f"{l32:.6f} vs {lp32:.6f}; worst gradient errors relative to "
              f"their scale "
              f"{[(n, '%.2e' % r, '%.2e' % e) for r, e, n in errs[:3]]}, "
              f"tolerance {MODEL_GRAD_TOLERANCE:.0e}  "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError("float32 train-step gradients disagree")
        del g32
    ref32 = {n: gp32[n] for n in gp16}
    d_k = {n: r for r, _, n in grad_errors(g16, ref32, "l2")}
    d_p = {n: r for r, _, n in grad_errors(gp16, ref32, "l2")}
    margin = sorted(((d_k[n] / (BF16_GRAD_FACTOR * d_p[n] + BF16_GRAD_SLACK),
                      n) for n in d_k), reverse=True)
    ok = margin[0][0] <= 1.0 and math.isfinite(l16)
    print(f"train step bf16, {what}: loss kernels {l16:.6f}, plain "
          f"{lp16:.6f}, float32 plain {lp32:.6f}; per parameter, l2 distance "
          f"from the float32 plain gradient relative to its scale, kernels "
          f"vs plain bf16, worst against the limit "
          f"{[(n, '%.2e' % d_k[n], '%.2e' % d_p[n]) for _, n in margin[:4]]}"
          f"; largest for the kernels "
          f"{[(n, '%.2e' % d_k[n], '%.2e' % d_p[n]) for n in sorted(d_k, key=d_k.get)[-3:]]}"
          f"; limit {BF16_GRAD_FACTOR:g} x plain + {BF16_GRAD_SLACK:g}, "
          f"worst at {margin[0][0]:.2f} of it  {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise AssertionError("bf16 train-step gradients disagree")


def collect_grads(K, cfg, build, loss_and_grad, f32_kernels=True):
    """One step's loss and gradients through the kernels and through
    their plain versions, in float32 (where the kernels train in float32)
    and in bf16, as ``check_step_grads`` takes them: ``build(mc)`` makes
    the model of config ``mc``, ``loss_and_grad(model, mc)`` returns the
    loss and the gradients in ``model.named_parameters()``' order."""
    import torch

    grads = {}
    for dtype_name in ("float32", "bfloat16"):
        mc = cfg.replace(dtype=dtype_name)
        for mode in ("kernel", "plain"):
            if mode == "kernel" and dtype_name == "float32" and not f32_kernels:
                continue
            model = build(mc)
            names = [n for n, _ in model.named_parameters()]
            with (mock.patch.multiple(K, **K.PLAIN) if mode == "plain"
                  else contextlib.nullcontext()):
                loss, gr = loss_and_grad(model, mc)
            gr = [torch.zeros_like(p) if g is None else g
                  for g, p in zip(gr, model.parameters())]
            grads[dtype_name, mode] = (float(loss.detach()),
                                       dict(zip(names, gr)))
            del model, gr
    return grads


def kernel_vs_plain_step(K, cfg, dev, preset="hqavit_c100", batch=BATCH):
    """The kernel train step against the plain step on the same weights,
    batch and seeds, at ``check_depth(cfg)``: the gradients of one step in
    float32 (where the kernels train in float32: n=16) and in bf16, then
    bf16 losses over BF16_STEPS steps."""
    import torch

    from qavit_tpu_torch.configs import get_preset
    from qavit_tpu_torch.kernels.fused_ref import make_geom
    from qavit_tpu_torch.nn.models import build_model
    from qavit_tpu_torch.train.optim import make_schedule
    from qavit_tpu_torch.train.state import create_train_state
    from qavit_tpu_torch.train.steps import loss_and_grads, make_train_step

    tc = get_preset(preset).train
    cfg = check_depth(cfg)
    print(f"kernel vs plain step checks at depth {cfg.depth}", flush=True)
    f32_kernels = K.kernel_geometry_error(make_geom(cfg), True,
                                          torch.float32) is None
    gen = torch.Generator().manual_seed(11)
    imgs = torch.randn(batch, cfg.img_size, cfg.img_size, 3,
                       generator=gen).to(dev)
    tgts = torch.randint(0, cfg.num_classes, (batch,), generator=gen).to(dev)
    def supervised(model, mc):
        names = [n for n, _ in model.named_parameters()]
        loss, _, _, gr = loss_and_grads(model, names, imgs, tgts, 12345, 0,
                                        mc, tc)
        return loss, gr

    grads = collect_grads(K, cfg, lambda mc: build_model(mc, dev, seed=0),
                          supervised, f32_kernels)
    check_step_grads(grads, f32_kernels, f"B={batch}")
    del grads
    # bf16: the preset's train step for BF16_STEPS steps, both ways
    losses = {}
    for mode in ("kernel", "plain"):
        model = build_model(cfg, dev, seed=0)
        state = create_train_state(model, tc.use_ema, tc.ema_decay)
        step = make_train_step(cfg, tc, make_schedule(tc, 50_000 //
                                                      tc.batch_size))
        with (mock.patch.multiple(K, **K.PLAIN) if mode == "plain"
              else contextlib.nullcontext()):
            losses[mode] = [float(step(state, imgs, tgts, 5)["loss"])
                            for _ in range(BF16_STEPS)]
        finite = all(bool(torch.isfinite(t).all()) for t in state.params())
        if not finite:
            raise AssertionError(f"bf16 {mode} step: parameters not finite")
        del model, state
    err = max(abs(a - b) / abs(b) for a, b in zip(losses["kernel"],
                                                  losses["plain"]))
    ok = err <= BF16_LOSS_TOLERANCE and all(map(math.isfinite,
                                                losses["kernel"]))
    print(f"train step bf16 kernels vs plain, {BF16_STEPS} steps at "
          f"B={batch}: losses {['%.5f' % v for v in losses['kernel']]} "
          f"vs {['%.5f' % v for v in losses['plain']]}, worst relative "
          f"{err:.2e}, tolerance {BF16_LOSS_TOLERANCE:.2e}  "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("bf16 train-step losses disagree")


def unit_train_work(name, g, b, dtype_bytes, p):
    """(bytes, flops) of a unit's train-mode forward: the eval work
    (unit_work) plus the bank write's: its projections read once (float32)
    and the [2, S, C] float32 sums written once; per sample the gate's
    product (C x S) and the gate-weighted sum of the write norm's rows
    (S x n x C), and the compression (C x C) once, of that sum: a sample's
    gate sums to 1 over its tokens, so the gate-weighted sum of the
    compressed rows is the compression of the gate-weighted sum
    (mma_ops.cuh, bank partials)."""
    nbytes, flops = unit_work(name, g, b, dtype_bytes, p)
    if name == "unit_cross_tail":
        return nbytes, flops
    n, c, s = g.n, g.c, g.bank_s
    w = 4 * (c * c + c * s + 4 * c + s)
    per = 2 * n * c * s + 2 * n * s * c
    return nbytes + w + 2 * s * c * 4, flops + b * per + 2 * s * c * c


def kernel_row(name, source, replaces, launches, err, ms, plain_ms, work,
               dtype, kernel_ms=None):
    """One entry of the kernels record; the bound is the larger of the
    bytes over the memory rate and the FLOPs over the type's peak.
    ``kernel_ms``: the kernel's own device time (device_ms), where taken;
    ``ms`` is the wrapper's call, by CUDA events."""
    nbytes, flops = work
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * flops / PEAK_FLOPS[str(dtype)]
    dev = ("" if kernel_ms is None
           else f" (kernel on the device {kernel_ms:.4f})")
    print(f"time {name:20s} {ms:.4f} ms{dev}  plain {plain_ms:.4f} ms  bound "
          f"{max(t_bytes, t_ops) * 1e3:.2f} us ({nbytes / 1e6:.1f} MB, "
          f"{flops / 1e9:.2f} GFLOP)  max_abs_err {err:.3e}", flush=True)
    row = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": launches, "max_abs_err": err,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": None}
    if kernel_ms is not None:
        row["device_ms"] = kernel_ms
    return row


def train_unit_checks_and_timing(K, cfg, g, p, dev, launches, bsz=BATCH,
                                 suffix=""):
    """Phases (h), (n): at batch ``bsz`` in bf16 with masks on, each unit
    through the autograd wrapper the train path calls (``_FusedUnit``):
    its outputs and bank partials against the plain version, its gradients
    (the backward kernel, launched by autograd) against autograd through
    the plain version.  Then each train-mode forward kernel and each
    backward kernel (with its reduction pass) timed against its plain
    version (record names + ``suffix``)."""
    import torch

    from qavit_tpu_torch.kernels import build
    from qavit_tpu_torch.kernels import fused_ref as R
    from qavit_tpu_torch.kernels import unit_checks as UC

    dtype = torch.bfloat16
    gen = torch.Generator().manual_seed(4)
    bankp = bank_write_params(cfg, g, gen, dev)
    rows = tuple((torch.randn(1, g.bank_s, g.c, generator=gen) * 0.5).to(dev)
                 for _ in range(2))
    lib = K.bind(build.load().lib)
    stream = torch.cuda.current_stream().cuda_stream
    grid = K.train_grid(dev, bsz)
    train = K.UnitTrain(R.block_rng(8, cfg.dropout, cfg.drop_path), bankp)
    x = torch.randn(bsz, g.n, g.c, generator=gen).to(dev, dtype)
    inputs = UC.unit_inputs(p, g, dtype, x, rows)
    fwd_rows, bwd_rows = [], []
    for unit in K.UNITS:
        batch = [t.detach() for t in inputs[unit]]
        n = K._N_DIFF_OUT[unit]
        cots = UC.random_cotangents(unit, batch, dtype, gen)
        leaves = [t.clone().requires_grad_(True) for t in batch]
        weights = [t for _, t in K.unit_params(unit, p)]
        got = K._train_unit(unit, p, leaves, g, dtype, train)
        ref = K.PLAIN[unit](p, *leaves, g, dtype, train)
        ref = ref if isinstance(ref, tuple) else (ref,)
        out_err, part_err = UC.forward_errors(got, ref, n)
        out_abs = max(K.max_abs_err(a, b) for a, b in zip(got[:n], ref[:n]))
        gk = torch.autograd.grad(got[:n], leaves + weights, cots,
                                 allow_unused=True)

        def plain_bwd():
            return torch.autograd.grad(ref[:n], leaves + weights, cots,
                                       retain_graph=True, allow_unused=True)

        gp = plain_bwd()
        pairs = [(a, b) for a, b in zip(gk, gp) if b is not None]
        grad_abs, grad_rel, grads_ok = K.compare_grads(pairs, dtype)
        ok = (grads_ok and out_err <= K.TOLERANCE[dtype]
              and part_err <= UC.PARTIAL_TOLERANCE)
        print(f"check {unit} wrapper n={g.n} B={bsz} {dtype}: outputs "
              f"{out_err:.2e}"
              f" (tolerance {K.TOLERANCE[dtype]:.2e}), partials "
              f"{part_err:.2e} ({UC.PARTIAL_TOLERANCE:.0e}), gradients "
              f"relative {grad_rel:.2e} (tolerance "
              f"{K.GRAD_TOLERANCE[dtype]:.2e})  {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            raise AssertionError(f"{unit} wrapper disagrees at n={g.n} "
                                 f"B={bsz}")
        del got, gk

        def fwd():
            return K._FWD[unit](lib, p, *batch, g, dtype, stream, train,
                                grid)

        def plain_fwd():
            with torch.no_grad():
                return K.PLAIN[unit](p, *batch, g, dtype, train)

        *_, ws = fwd()

        def bwd():
            return K._BWD[unit](lib, p, *batch, g, dtype, stream, train,
                                grid, ws, *cots)

        kern = csrc_kernel(K, unit, g, dtype, train=True)
        src = (f"qavit_tpu_torch/csrc/{unit}"
               f"{'_train64' if kern.endswith('_train64_kernel') else ''}.cu")
        fwd_rows.append(kernel_row(
            f"{record_name(K, unit, g, dtype)}_train{suffix}", src,
            REPLACES[unit], launches[unit], out_abs,
            cuda_ms(fwd, iters=10), cuda_ms(plain_fwd, iters=10),
            unit_train_work(unit, g, bsz, 2, p), dtype,
            device_ms(fwd, 10, kern)))
        name = f"{unit}_bwd"
        bwd_rows.append(kernel_row(
            record_name(K, unit, g, dtype, True) + suffix,
            f"qavit_tpu_torch/csrc/{name}.cu", REPLACES[name],
            launches[name], grad_abs, cuda_ms(bwd, iters=10),
            cuda_ms(plain_bwd, iters=10),
            unit_bwd_work(unit, g, bsz, 2, p), dtype,
            device_ms(bwd, 10, csrc_kernel(K, unit, g, dtype, True))))
        del ref, leaves
    fwd_ms = sum(r["ms"] for r in fwd_rows)
    bwd_ms = sum(r["ms"] for r in bwd_rows)
    print(f"units per train step ({cfg.depth} blocks): forward kernels "
          f"{cfg.depth * fwd_ms:.2f} ms, backward kernels "
          f"{cfg.depth * bwd_ms:.2f} ms; their plain versions "
          f"{cfg.depth * sum(r['plain_ms'] for r in fwd_rows):.2f} ms and "
          f"{cfg.depth * sum(r['plain_ms'] for r in bwd_rows):.2f} ms",
          flush=True)
    return fwd_rows + bwd_rows


def csrc_kernel(K, unit, g, dtype, backward=False, train=False):
    """The csrc kernel a launch of ``unit`` (its backward; in train mode)
    runs at geometry ``g``: the tensor-core one where the route takes
    it."""
    if backward:
        entry = K.bwd_entry(unit, g, dtype)
        if entry in ("unit_msda_bwd_mma64", "unit_cga_bwd_mma64",
                     "unit_cross_tail_bwd_mma64"):
            return f"{unit[5:]}_bwd_mma64_kernel"
        mma = entry != f"{unit}_bwd"
        return f"{unit[5:]}_bwd{'_mma' if mma else ''}_kernel"
    route = {"unit_swa": K.swa_route, "unit_msda": K.msda_route,
             "unit_cga": K.cga_route,
             "unit_cross_tail": K.cross_tail_route}.get(unit)
    if route is not None and route(g, dtype, train).endswith("_train64"):
        return ("cga_mma_kernel" if unit == "unit_cga"
                else f"{unit[5:]}_train64_kernel")
    if route is None or not route(g, dtype).endswith("_mma"):
        return f"{unit[5:]}_kernel"
    return "msda_mma16_kernel" if unit == "unit_msda" and g.n == 16 else (
        f"{unit[5:]}_mma_kernel")


def record_name(K, unit, g, dtype, backward=False):
    """A row's name in the kernels record: the tensor-core kernel's where
    the launch takes it, else the unit's (``unit_*_bwd``)."""
    kern = csrc_kernel(K, unit, g, dtype, backward)
    return kern if "_mma" in kern else unit + ("_bwd" if backward else "")


def mma16_checks(K, g, p, bank, dev, gen, batch):
    """Phases (c), (e): the bf16 SWA, MSDA, CGA and cross/tail units at
    n=16 against their plain versions (2^-6 of max|plain|) at ``batch`` as
    they are; with a NaN in one sample's input (the guard: SWA's x and
    MSDA's and CGA's xn make every sample's output proj(0), SWA's xn
    keeping the NaN row; cross/tail's xn, read by the cross branch's q
    only, makes every sample's cross attention zero, the block output
    finite); with 12 bank rows; and at ``batch - 1`` samples (a short last
    tile of three).  Each launch must take the tensor-core entry.  Raises
    on a failure."""
    import torch

    dtype = torch.bfloat16
    x = (torch.randn(batch, g.n, g.c, generator=gen) * 2).to(dev, dtype)
    g12 = g._replace(bank_s=12)
    bank12 = tuple(t[:, :12].contiguous() for t in bank)
    failed = []
    for case in ("as it is", "NaN guard", "12 bank rows", "short last tile"):
        gc, bc = (g12, bank12) if case == "12 bank rows" else (g, bank)
        xc = x[:batch - 1] if case == "short last tile" else x
        o, xn = K.swa_plain(p, xc, *bc, gc, dtype)
        m = K.msda_plain(p, xn, *bc, gc, dtype)
        c = K.cga_plain(p, xn, *bc, gc, dtype)
        xs, xns = xc, xn
        if case == "NaN guard":
            xs, xns = xc.clone(), xn.clone()
            xs[batch // 2, 3, 5] = xns[batch // 2, 3, 5] = float("nan")
        ct = (xc, xns, o, m, c, *bc, gc, dtype)
        calls = {
            "unit_swa": (lambda: K.unit_swa(p, xs, *bc, gc, dtype),
                         lambda: K.swa_plain(p, xs, *bc, gc, dtype)),
            "unit_msda": (lambda: K.unit_msda(p, xns, *bc, gc, dtype),
                          lambda: K.msda_plain(p, xns, *bc, gc, dtype)),
            "unit_cga": (lambda: K.unit_cga(p, xns, *bc, gc, dtype),
                         lambda: K.cga_plain(p, xns, *bc, gc, dtype)),
            "unit_cross_tail": (lambda: K.unit_cross_tail(p, *ct),
                                lambda: K.cross_tail_plain(p, *ct))}
        for unit, (kern, plain) in calls.items():
            K.reset_launches()
            out = kern()
            torch.cuda.synchronize()
            routed = (K.ROUTES[f"{unit}_mma"], K.ROUTES[unit]) == (1, 0)
            ref = plain()
            err, ok = guarded_error(K, out, ref)
            ok = ok and routed and (unit != "unit_cross_tail"
                                    or bool(torch.isfinite(ref).all()))
            # the worst output's error as a share of its own bound
            share = max(
                K.max_abs_err(o[~torch.isnan(r)], r[~torch.isnan(r)])
                / (K.TOLERANCE[dtype] * r[~torch.isnan(r)].float().abs()
                   .max().item())
                for o, r in zip(*(t if isinstance(t, tuple) else (t,)
                                  for t in (out, ref))))
            print(f"check {unit:16s} bf16 n={g.n} B={xc.shape[0]} {case} "
                  f"(tensor-core entry {routed}): max_abs_err {err:.3e}, "
                  f"{share:.2f} of its bound (2^-6 of max|plain|)"
                  f"  {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                failed.append((unit, case))
    if failed:
        raise AssertionError(f"the n={g.n} bf16 tensor-core units disagree: "
                             f"{failed}")


def reset_launches() -> None:
    """Every kernel's launch count to 0 (the units' and the flash
    kernel's)."""
    from qavit_tpu_torch.kernels import flash_attention as FA
    from qavit_tpu_torch.kernels import fused_kernels as K

    K.reset_launches()
    FA.reset_launches()


def launch_counts() -> dict:
    from qavit_tpu_torch.kernels import flash_attention as FA
    from qavit_tpu_torch.kernels import fused_kernels as K

    return {**K.LAUNCHES, **FA.LAUNCHES}


def flash_inputs(shape, dtype, dev, gen):
    """q [B, Nq, H, D], k, v [B, Nkv, H, D] from ``gen``; broadcast keys
    are one [1, Nkv, H, D] row expanded over the batch (stride 0)."""
    import torch

    _, b, nq, nkv, h, d, broadcast = shape
    q = torch.randn(b, nq, h, d, generator=gen).to(dev, dtype)
    kb = 1 if broadcast else b
    k, v = (torch.randn(kb, nkv, h, d, generator=gen).to(dev, dtype)
            .expand(b, -1, -1, -1) for _ in range(2))
    return q, k, v


def flash_work(q, k, v):
    """(bytes, flops) of one attention call: every distinct element of
    q, k, v read once (a stride-0 batch is one row), the output written
    once; 2 x Nq x Nkv x D multiply-adds per (batch, head) for q k^T
    and again for p v."""
    def distinct(t):
        n = 1
        for size, stride in zip(t.shape, t.stride()):
            n *= size if stride else 1
        return n

    b, nq, h, d = q.shape
    nbytes = (2 * q.numel() + distinct(k) + distinct(v)) * q.element_size()
    return nbytes, 4 * b * h * nq * k.shape[1] * d


def flash_checks(dev):
    """Phase (i): the flash kernel against its plain version at every
    shape of FLASH_SHAPES, float32 and bf16, dropout 0 and 0.1; the
    autograd Function's backward against autograd through the plain
    version; the times at the 224 path's shapes."""
    import torch
    import torch.nn.functional as F

    from qavit_tpu_torch.kernels import attention as A
    from qavit_tpu_torch.kernels import build
    from qavit_tpu_torch.kernels import flash_attention as FA
    from qavit_tpu_torch.kernels import fused_kernels as K

    gen = torch.Generator().manual_seed(5)
    failed, errs = [], {}
    for shape in FLASH_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = flash_inputs(shape, dtype, dev, gen)
            for rate in (0.0, 0.1):
                with torch.inference_mode():
                    out = FA.flash_attention(q, k, v, rate, 1234)
                    torch.cuda.synchronize()
                    ref = FA.plain(q, k, v, rate, 1234)
                ok = K.within_tolerance(out, ref)
                err = K.max_abs_err(out, ref)
                errs[shape[0], dtype, rate] = err
                print(f"check flash_attention {shape[0]:20s} q "
                      f"{tuple(q.shape)} kv {tuple(k.shape)}{' (stride-0 '
                      'batch)' if shape[6] else ''} {str(dtype):15s} dropout "
                      f"{rate}: max_abs_err {err:.3e} (relative "
                      f"{err / ref.float().abs().max().item():.2e}, tolerance"
                      f" {K.TOLERANCE[dtype]:.2e})  {'ok' if ok else 'FAIL'}",
                      flush=True)
                if not ok:
                    failed.append((shape[0], str(dtype), rate))
    # the Function the dispatch calls: kernel forward, recompute backward
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (t.detach().clone().requires_grad_(True)
                   for t in flash_inputs(FLASH_SHAPES[0], dtype, dev, gen))
        ct = torch.randn(q.shape, generator=gen).to(dev, dtype)
        out = A._FlashAttention.apply(q, k, v)
        got = torch.autograd.grad(out, (q, k, v), ct)
        ref_out = FA.plain(q, k, v)
        ref = torch.autograd.grad(ref_out, (q, k, v), ct)
        grad_abs, grad_rel, ok = K.compare_grads(list(zip(got, ref)), dtype)
        ok = ok and K.within_tolerance(out.detach(), ref_out.detach())
        print(f"check flash_attention backward (recompute) {dtype}: "
              f"gradients max_abs_err {grad_abs:.3e}, relative "
              f"{grad_rel:.2e} (tolerance {K.GRAD_TOLERANCE[dtype]:.2e})  "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failed.append(("backward", str(dtype)))
    if failed:
        raise AssertionError(f"flash kernel disagrees: {failed}")

    dtype, rows = torch.bfloat16, []
    print_ptxas("flash_mma_kernel")
    lib = K.bind(build.load().lib)
    for shape in FLASH_SHAPES[:2]:
        q, k, v = flash_inputs(shape, dtype, dev, gen)
        print(f"flash_mma_kernel at {shape[0]}: "
              f"{FA.smem_bytes(lib, q, k, v)} B of dynamic shared memory "
              f"per block", flush=True)
        # the library's own layout [B, H, N, D], made outside the timing
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        with torch.inference_mode():
            call_ms = cuda_ms(lambda: FA.flash_attention(q, k, v))
            dev_ms = device_ms(lambda: FA.flash_attention(q, k, v))
            plain_ms = cuda_ms(lambda: FA.plain(q, k, v))
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt))
        # the kernel's own time where the profiler saw it, else per call
        ms = call_ms if dev_ms is None else dev_ms
        nbytes, flops = flash_work(q, k, v)
        t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
        t_ops = 1e3 * flops / PEAK_FLOPS[str(dtype)]
        rows.append({"shape": shape[0], "q": list(q.shape),
                     "kv": list(k.shape), "ms": ms, "call_ms": call_ms,
                     "plain_ms": plain_ms,
                     "library_ms": lib_ms, "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops else
                     "operations", "max_abs_err": errs[shape[0], dtype, 0.0]})
        print(f"time flash_attention {shape[0]:10s} {ms:.4f} ms on the "
              f"device (torch.profiler; {call_ms:.4f} ms per call, CUDA "
              f"events)  plain {plain_ms:.4f} ms  "
              f"scaled_dot_product_attention {lib_ms:.4f} ms  bound "
              f"{max(t_bytes, t_ops) * 1e3:.2f} us ({nbytes / 1e6:.1f} MB, "
              f"{flops / 1e9:.2f} GFLOP)", flush=True)
    return rows


def device_kernels(prof):
    """[(name, device ms, calls)] of the device's own events in a
    ``torch.profiler`` run, longest first (an operator's row would count
    its kernels again)."""
    from torch.autograd import DeviceType

    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((ev.key, us / 1e3, ev.count))
    return sorted(rows, key=lambda r: -r[1])


def device_ms(fn, iters: int = 20, kernel=None):
    """Device time per call of the kernels ``fn`` launches, from
    ``torch.profiler`` after a warm-up (None where the profiler saw no
    device time); with ``kernel``, of the csrc kernel of that name alone
    (not the wrapper's casts, memsets or reduction pass).  CUDA events
    around back-to-back calls measure the host instead when a call's host
    work outlasts its kernel, as the flash wrapper's does at some 0.05
    ms."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    pick = re.compile(rf"qv::{kernel}[<(]") if kernel else None
    total = sum(ms for name, ms, _ in device_kernels(prof)
                if pick is None or pick.search(name))
    return total / iters if total > 0 else None


def profile_forward(model, images, top: int = 10):
    """One traced forward after a warm-up: ([(name, device ms, calls)]
    of the ``top`` kernels by device time, device-busy ms, wall ms).
    Busy ms is 0.0 where the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        model(images)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model(images)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = device_kernels(prof)
    return rows[:top], sum(r[1] for r in rows), wall_ms


def flat_path(dev, flash_rows):
    """Phase (j): the 224 eval path through the evaluate CLI with the
    counts reset just before; then its logits kernel against plain and
    its forward's time.  Returns the flash kernel's record entry (times
    per launch averaged over the path's two shapes, whose launches split
    evenly)."""
    import torch

    from qavit_tpu_torch.cli import evaluate
    from qavit_tpu_torch.configs import get_preset
    from qavit_tpu_torch.data.augment import eval_batch
    from qavit_tpu_torch.data.datasets import synthetic_dataset
    from qavit_tpu_torch.data.pipelines import get_pipeline
    from qavit_tpu_torch.kernels import flash_attention as FA
    from qavit_tpu_torch.nn.models import build_model

    preset = get_preset(FLAT_PRESET)
    cfg = preset.model
    reset_launches()
    r = evaluate.main(["--preset", FLAT_PRESET, "--synthetic", "--seed", "0",
                       "--batch-size", str(FLAT_BATCH), "--batches",
                       str(FLAT_BATCHES)])
    launches = launch_counts()
    forwards = FLAT_BATCHES + 2       # + the smoke and the untimed batch
    print(f"224 path: {r['count']} images, top-1 {r['top1']:.2f}%, loss "
          f"{r['loss']:.4f}, {r['img_per_s']:.1f} img/s (host clock, "
          f"{forwards} forwards); launches {launches}", flush=True)
    want = {n: 2 * cfg.depth * forwards if n == "flash_attention" else 0
            for n in launches}
    if launches != want:
        raise AssertionError(f"224 path launches {launches}, expected "
                             f"{want} (MSDA and cross in each of "
                             f"{cfg.depth} blocks per forward)")
    if not (r["count"] == FLAT_BATCH * FLAT_BATCHES and r["loss"] == r["loss"]
            and 0.0 <= r["top1"] <= r["top5"] <= 100.0):
        raise AssertionError(f"224 path result out of range: {r}")

    ds = synthetic_dataset(preset.dataset, cfg.img_size, cfg.num_classes,
                           n_train=0, n_test=FLAT_BATCH, seed=0)
    images = eval_batch(torch.from_numpy(ds.test_images).to(dev),
                        get_pipeline(preset.dataset).aug)
    model_tol = {"bfloat16": 2.0 ** -4, "float32": 1e-4}
    for dtype_name in ("bfloat16", "float32"):
        model = build_model(cfg.replace(dtype=dtype_name), dev, seed=0)
        with torch.inference_mode():
            lk, _ = model(images)
            with mock.patch.object(FA, "flash_attention", FA.plain):
                lp, _ = model(images)
        err = (lk - lp).abs().max().item()
        bound = model_tol[dtype_name] * lp.abs().max().item()
        agree = (lk.argmax(-1) == lp.argmax(-1)).float().mean().item()
        ok = (bool(torch.isfinite(lk).all()) and err <= bound
              and tuple(lk.shape) == (FLAT_BATCH, cfg.num_classes))
        print(f"224 logits kernel vs plain, {dtype_name}: max_abs_err "
              f"{err:.3e} tolerance {bound:.3e} (max|logit| "
              f"{lp.abs().max().item():.3e}), top-1 agreement "
              f"{100 * agree:.2f}%  {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"{dtype_name} 224 logits disagree")
        del model
    model = build_model(cfg, dev, seed=0)
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: model(images), iters=10)
    flash_ms = cfg.depth * sum(row["ms"] for row in flash_rows)
    print(f"224 eval forward: {fwd_ms:.3f} ms per batch of {FLAT_BATCH}, "
          f"{1000 * FLAT_BATCH / fwd_ms:.1f} img/s (CUDA events, bf16); "
          f"flash launches {flash_ms:.3f} ms of it", flush=True)
    top, busy_ms, wall_ms = profile_forward(model, images)
    if busy_ms > 0:
        print(f"224 eval forward traced (torch.profiler, one forward): "
              f"device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms wall, idle "
              f"share {1 - busy_ms / wall_ms:.3f}", flush=True)
        for name, ms, calls in top:
            print(f"  {ms:8.3f} ms  {calls:4d} calls  {name[:90]}",
                  flush=True)
    else:
        print("224 eval forward traced: the profiler saw no device time; "
              "breakdown not measured", flush=True)

    def mean(key):
        return sum(row[key] for row in flash_rows) / len(flash_rows)

    return {"name": "flash_attention", "route": "cuda",
            "source": "qavit_tpu_torch/csrc/flash_attention.cu",
            "replaces": REPLACES["flash_attention"],
            "launches": launches["flash_attention"],
            "max_abs_err": max(row["max_abs_err"] for row in flash_rows),
            "ms": mean("ms"), "call_ms": mean("call_ms"),
            "plain_ms": mean("plain_ms"),
            "bound_ms": mean("bound_ms"), "bound_by": "bytes" if all(
                row["bound_by"] == "bytes" for row in flash_rows)
            else "operations", "library_ms": mean("library_ms"),
            "per_shape": flash_rows}


def guarded_error(K, out, ref):
    """(max abs err over the entries that are finite in the plain version,
    ok): NaNs must sit where the plain version has them."""
    import torch

    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    err, ok = 0.0, True
    for o, r in zip(outs, refs):
        nan = torch.isnan(r)
        ok = ok and torch.equal(torch.isnan(o), nan)
        fin = ~nan
        if fin.any():
            e = K.max_abs_err(o[fin], r[fin])
            err = max(err, e)
            ok = ok and e <= K.TOLERANCE[r.dtype] * r[fin].float().abs().max(
            ).item()
    return err, ok


def multiwindow_checks(K, dev):
    """Phase (k): each forward unit against its plain version at the
    hqavit_proc_tin geometry, float32 and bf16, B=CHECK_BATCH; then with a
    NaN in one sample (float32): the guard is batch-wide, so the plain
    version zeroes every sample's attention output and the kernels must
    give the same values and the same NaNs."""
    import torch

    from qavit_tpu_torch.configs import get_preset
    from qavit_tpu_torch.kernels import build
    from qavit_tpu_torch.kernels.fused_ref import make_geom
    from qavit_tpu_torch.nn.layers import param_tree

    cfg = get_preset(TIN_PRESET).model
    g = make_geom(cfg)
    gen = torch.Generator().manual_seed(6)
    p = param_tree(perturbed_block(cfg, g, gen).to(dev))
    bank = tuple((torch.randn(1, g.bank_s, g.c, generator=gen) * 0.5).to(dev)
                 for _ in range(2))
    print(f"geometry: n={g.n} on a {math.isqrt(g.n)}x{math.isqrt(g.n)} grid, "
          f"{g.nw} SWA windows of {g.ws2}, {g.msda_keep} pooled MSDA rows, "
          f"C={g.c}", flush=True)
    failed = []
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.randn(CHECK_BATCH, g.n, g.c, generator=gen) * 2).to(
                dev, dtype)
            for name, (kern, plain) in unit_calls(K, p, g, dtype, x,
                                                  bank).items():
                K.reset_launches()
                out = kern()
                torch.cuda.synchronize()
                err, rel, bound, ok = worst_error(K, out, plain())
                # bf16 at n=64: every unit on its tensor-core entry
                want = f"{name}_mma" if dtype == torch.bfloat16 else name
                ok = ok and K.ROUTES[want] == 1
                print(f"check {name:16s} n={g.n} {str(dtype):15s} "
                      f"B={CHECK_BATCH} max_abs_err {err:.3e} (relative to "
                      f"max|plain| {rel:.2e}, tolerance "
                      f"{K.TOLERANCE[dtype]:.2e})  {'ok' if ok else 'FAIL'}",
                      flush=True)
                if not ok:
                    failed.append((name, str(dtype)))
        x = torch.randn(CHECK_BATCH, g.n, g.c, generator=gen).to(dev)
        x[7, 3, 5] = float("nan")
        for name, (kern, plain) in unit_calls(K, p, g, torch.float32, x,
                                              bank).items():
            out = kern()
            torch.cuda.synchronize()
            err, ok = guarded_error(K, out, plain())
            print(f"check {name:16s} n={g.n} NaN guard (one NaN in sample "
                  f"7): NaNs where plain has them, max_abs_err {err:.3e} "
                  f"elsewhere  {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                failed.append((name, "guard"))
        out, _ = K.unit_swa(p, x, *bank, g, torch.float32)
        if not torch.equal(out, p["swa"]["proj"]["bias"].expand_as(out)):
            failed.append(("unit_swa", "guard not batch-wide"))
        # the bf16 tensor-core MSDA kernel's guard: every sample proj(0)
        xn = K.swa_plain(p, x.to(torch.bfloat16), *bank, g,
                         torch.bfloat16)[1]
        out = K.unit_msda(p, xn, *bank, g, torch.bfloat16)
        torch.cuda.synchronize()
        ref = K.msda_plain(p, xn, *bank, g, torch.bfloat16)
        ok = torch.equal(out, ref)
        print(f"check unit_msda         n={g.n} NaN guard bf16 (one NaN in "
              f"sample 7): equal to plain {ok}, max_abs_err "
              f"{K.max_abs_err(out, ref):.3e}  {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            failed.append(("unit_msda", "guard bf16"))
        # the bf16 tensor-core CGA kernel's guard, through its own entry:
        # every sample proj(0)
        K.reset_launches()
        out = K.unit_cga(p, xn, *bank, g, torch.bfloat16)
        torch.cuda.synchronize()
        ref = K.cga_plain(p, xn, *bank, g, torch.bfloat16)
        ok = torch.equal(out, ref) and K.ROUTES["unit_cga_mma"] == 1
        print(f"check unit_cga          n={g.n} NaN guard bf16 (one NaN in "
              f"sample 7): equal to plain {torch.equal(out, ref)}, "
              f"tensor-core entry {K.ROUTES['unit_cga_mma'] == 1}  "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failed.append(("unit_cga", "guard bf16"))
        # the bf16 SWA and cross/tail kernels' guards: a NaN in one
        # sample's x (SWA: every sample's output proj(0), xn keeps the NaN
        # row) or xn (read by the cross branch's q only: every sample's
        # cross attention zero, the block output finite)
        xb = x.to(torch.bfloat16)
        o, xn = K.swa_plain(p, xb, *bank, g, torch.bfloat16)
        m = K.msda_plain(p, xn, *bank, g, torch.bfloat16)
        c = K.cga_plain(p, xn, *bank, g, torch.bfloat16)
        ct = (xb.nan_to_num(), xn, o, m, c, *bank, g, torch.bfloat16)
        for name, (kern, plain) in (
                ("unit_swa", (lambda: K.unit_swa(p, xb, *bank, g,
                                                 torch.bfloat16),
                              lambda: (o, xn))),
                ("unit_cross_tail",
                 (lambda: K.unit_cross_tail(p, *ct),
                  lambda: K.cross_tail_plain(p, *ct)))):
            out = kern()
            torch.cuda.synchronize()
            err, ok = guarded_error(K, out, plain())
            print(f"check {name:16s} n={g.n} NaN guard bf16 (one NaN in "
                  f"sample 7): NaNs where plain has them, max_abs_err "
                  f"{err:.3e} elsewhere  {'ok' if ok else 'FAIL'}",
                  flush=True)
            if not ok:
                failed.append((name, "guard bf16"))
        # the bf16 tensor-core kernels with 12 bank rows (padded keys
        # masked)
        g12 = g._replace(bank_s=12)
        bank12 = tuple(t[:, :12].contiguous() for t in bank)
        x = (torch.randn(CHECK_BATCH, g.n, g.c, generator=gen) * 2).to(
            dev, torch.bfloat16)
        for name, (kern, plain) in unit_calls(K, p, g12, torch.bfloat16, x,
                                              bank12).items():
            err, rel, _, ok = worst_error(K, kern(), plain())
            print(f"check {name:16s} n={g.n} bf16 12 bank rows "
                  f"B={CHECK_BATCH} max_abs_err {err:.3e} (relative "
                  f"{rel:.2e})  {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                failed.append((name, "12 bank rows"))
    if failed:
        raise AssertionError(f"n={g.n} unit kernels disagree: {failed}")
    lib = K.bind(build.load().lib)
    d64 = K._dims(g, CHECK_BATCH, p, 1, 1, None)
    for unit in ("swa", "msda", "cga", "cross_tail"):
        print_ptxas(f"{unit}_mma_kernel")
        smem = getattr(lib, f"qv_unit_{unit}_mma_smem")(ctypes.byref(d64))
        print(f"{unit}_mma_kernel: {smem} B of dynamic shared memory per "
              f"block", flush=True)
    return g, p, bank


def multiwindow_path(K, dev, g, p, bank):
    """Phase (l): the hqavit_proc_tin eval path through the evaluate CLI
    with the counts reset just before; its logits kernels against plain;
    its forward's time at two batches; each unit's time at B=1024 against
    its plain version and bound (the kernel record's @n64 rows); one
    traced forward."""
    import torch

    from qavit_tpu_torch.cli import evaluate
    from qavit_tpu_torch.configs import get_preset
    from qavit_tpu_torch.data.augment import eval_batch
    from qavit_tpu_torch.data.datasets import synthetic_dataset
    from qavit_tpu_torch.data.pipelines import get_pipeline
    from qavit_tpu_torch.nn.models import build_model

    preset = get_preset(TIN_PRESET)
    cfg = preset.model
    reset_launches()
    r = evaluate.main(["--preset", TIN_PRESET, "--synthetic", "--seed", "0",
                       "--batch-size", str(TIN_BATCH), "--batches",
                       str(TIN_BATCHES)])
    launches = launch_counts()
    forwards = TIN_BATCHES + 2        # + the smoke and the untimed batch
    print(f"n=64 path ({TIN_PRESET}, {cfg.depth} blocks): {r['count']} "
          f"images, top-1 {r['top1']:.2f}%, loss {r['loss']:.4f}, "
          f"{r['img_per_s']:.1f} img/s (host clock, {forwards} forwards); "
          f"launches {launches}", flush=True)
    want = {n: cfg.depth * forwards if n in K.UNITS else 0 for n in launches}
    if launches != want:
        raise AssertionError(f"n=64 path launches {launches}, expected "
                             f"{want} ({cfg.depth} of each forward unit per "
                             f"forward)")
    routes = dict(K.ROUTES)
    print(f"n=64 path: launches per C entry {routes}", flush=True)
    for unit in K.UNITS:      # bf16: every unit on its tensor-core entry
        if (routes[f"{unit}_mma"], routes[unit]) != (cfg.depth * forwards,
                                                     0):
            raise AssertionError(
                f"{unit}: {routes[f'{unit}_mma']} launches of the "
                f"tensor-core entry and {routes[unit]} of the CUDA-core one "
                f"in the n=64 path, expected {cfg.depth * forwards} and 0")
    if not (r["count"] == TIN_BATCH * TIN_BATCHES and r["loss"] == r["loss"]
            and 0.0 <= r["top1"] <= r["top5"] <= 100.0):
        raise AssertionError(f"n=64 path result out of range: {r}")

    ds = synthetic_dataset(preset.dataset, cfg.img_size, cfg.num_classes,
                           n_train=0, n_test=TIN_BIG_BATCH, seed=0)
    big = eval_batch(torch.from_numpy(ds.test_images).to(dev),
                     get_pipeline(preset.dataset).aug)
    images = big[:TIN_BATCH]
    model_tol = {"bfloat16": 2.0 ** -4, "float32": 1e-4}
    for dtype_name in ("bfloat16", "float32"):
        model = build_model(cfg.replace(dtype=dtype_name), dev, seed=0)
        with torch.inference_mode():
            lk, _ = model(images)
            with mock.patch.multiple(K, **K.PLAIN):
                lp, _ = model(images)
        err = (lk - lp).abs().max().item()
        bound = model_tol[dtype_name] * lp.abs().max().item()
        agree = (lk.argmax(-1) == lp.argmax(-1)).float().mean().item()
        ok = (bool(torch.isfinite(lk).all()) and err <= bound
              and tuple(lk.shape) == (TIN_BATCH, cfg.num_classes))
        print(f"n=64 logits kernels vs plain, {dtype_name}: max_abs_err "
              f"{err:.3e} tolerance {bound:.3e} (max|logit| "
              f"{lp.abs().max().item():.3e}), top-1 agreement "
              f"{100 * agree:.2f}%  {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"{dtype_name} n=64 logits disagree")
        del model
    model = build_model(cfg, dev, seed=0)
    for batch in (images, big):
        with torch.inference_mode():
            fwd_ms = cuda_ms(lambda: model(batch), iters=10)
        b = batch.shape[0]
        print(f"n=64 eval forward: {fwd_ms:.3f} ms per batch of {b}, "
              f"{1000 * b / fwd_ms:.1f} img/s (CUDA events, bf16)",
              flush=True)

    dtype, rows = torch.bfloat16, []
    gen = torch.Generator().manual_seed(9)
    with torch.inference_mode():
        x = torch.randn(TIN_BIG_BATCH, g.n, g.c, generator=gen).to(dev, dtype)
        for name, (kern, plain_fn) in unit_calls(K, p, g, dtype, x,
                                                 bank).items():
            err, _, _, ok = worst_error(K, kern(), plain_fn())
            if not ok:
                raise AssertionError(f"{name} n=64 disagrees at "
                                     f"B={TIN_BIG_BATCH}")
            rows.append(kernel_row(
                f"{name}@n64", f"qavit_tpu_torch/csrc/{name}.cu",
                REPLACES[name], launches[name], err, cuda_ms(kern, iters=10),
                cuda_ms(plain_fn, iters=10),
                unit_work(name, g, TIN_BIG_BATCH, 2, p), dtype,
                device_ms(kern, 10, csrc_kernel(K, name, g, dtype))))
    print(f"units per forward at B={TIN_BIG_BATCH} ({cfg.depth} blocks): "
          f"kernels {cfg.depth * sum(r['ms'] for r in rows):.2f} ms, plain "
          f"{cfg.depth * sum(r['plain_ms'] for r in rows):.2f} ms",
          flush=True)
    top, busy_ms, wall_ms = profile_forward(model, images)
    if busy_ms > 0:
        print(f"n=64 eval forward traced at B={TIN_BATCH} (torch.profiler, "
              f"one forward): device busy {busy_ms:.3f} ms of "
              f"{wall_ms:.3f} ms wall, idle share "
              f"{1 - busy_ms / wall_ms:.3f}", flush=True)
        for name, ms, calls in top:
            print(f"  {ms:8.3f} ms  {calls:4d} calls  {name[:90]}",
                  flush=True)
    else:
        print("n=64 eval forward traced: the profiler saw no device time; "
              "breakdown not measured", flush=True)
    return rows


N64_TRAIN_KERNELS = (
    # (ptxas name, its C entry for the shared memory)
    ("swa_train64_kernel", "unit_swa_mma_train64"),
    ("msda_train64_kernel", "unit_msda_mma_train64"),
    ("cga_mma_kernel<1,1>", "unit_cga_mma_train64"),
    ("cross_tail_train64_kernel", "unit_cross_tail_mma_train64"),
    ("swa_bwd_mma_kernel<4>", "unit_swa_bwd_mma64"),
    ("msda_bwd_mma64_kernel", "unit_msda_bwd_mma64"),
    ("cga_bwd_mma64_kernel", "unit_cga_bwd_mma64"),
    ("cross_tail_bwd_mma64_kernel", "unit_cross_tail_bwd_mma64"),
)


def n64_train_checks(K, dev, g, p):
    """Phase (m): at hqavit_proc_tin's geometry in bf16 with masks on,
    each unit's train-mode forward kernel and backward kernel against the
    plain version and autograd through it (unit_checks.check_unit), each
    launch through its n=64 entry: at B=CHECK_BATCH, with the NaN guard
    tripped in one sample, with 12 bank rows, and at B=CHECK_BATCH - 1;
    then the eight kernels' ptxas lines and shared memory."""
    import torch

    from qavit_tpu_torch.configs import get_preset
    from qavit_tpu_torch.kernels import build
    from qavit_tpu_torch.kernels import fused_ref as R
    from qavit_tpu_torch.kernels import unit_checks as UC

    cfg = get_preset(TIN_PRESET).model
    dtype, failed = torch.bfloat16, []
    gen = torch.Generator().manual_seed(13)
    bankp = bank_write_params(cfg, g, gen, dev)
    rows = tuple((torch.randn(1, g.bank_s, g.c, generator=gen) * 0.5).to(dev)
                 for _ in range(2))
    lib = K.bind(build.load().lib)
    stream = torch.cuda.current_stream().cuda_stream
    train = K.UnitTrain(R.block_rng(14, 0.1, 0.1), bankp)
    g12, rows12, train12 = twelve_bank_rows(K, g, rows, train)
    for case in ("masks", "NaN guard", "12 bank rows",
                 f"B={CHECK_BATCH - 1}"):
        b = CHECK_BATCH - 1 if case.startswith("B=") else CHECK_BATCH
        twelve, guard = case == "12 bank rows", case == "NaN guard"
        gc, rc, tr = (g12, rows12, train12) if twelve else (g, rows, train)
        x = (torch.randn(b, g.n, g.c, generator=gen) * 2).to(dev, dtype)
        inputs = UC.unit_inputs(p, gc, dtype, x, rc)
        for unit in K.UNITS:
            batch = list(inputs[unit])
            if guard:
                lead = 1 if unit == "unit_cross_tail" else 0
                batch[lead] = batch[lead].clone()
                batch[lead][b // 2, 3, 5] = float("nan")
            cots = UC.random_cotangents(unit, batch, dtype, gen)
            K.reset_launches()
            r = UC.check_unit(lib, unit, p, tr, batch, gc, dtype,
                              K.train_grid(dev, b), cots, stream,
                              guard_tripped=guard)
            routed = (K.ROUTES[f"{unit}_mma_train64"] == 1
                      and K.ROUTES[f"{unit}_bwd_mma64"] == 1
                      and sum(K.ROUTES.values()) == 2)
            ok = r.ok and routed
            print(f"check {unit} n={g.n} train bf16 {case} B={b} (n=64 "
                  f"entries {routed}): flag {r.flag}, outputs "
                  f"{r.out_err:.2e} (tolerance {K.TOLERANCE[dtype]:.2e}), "
                  f"partials {r.part_err:.2e} "
                  f"({UC.PARTIAL_TOLERANCE:.0e}), gradients max_abs_err "
                  f"{r.grad_abs:.3e}, relative {r.grad_err:.2e} (tolerance "
                  f"{K.GRAD_TOLERANCE[dtype]:.2e})  {'ok' if ok else 'FAIL'}",
                  flush=True)
            if not ok:
                failed.append((unit, case))
    for kern, entry in N64_TRAIN_KERNELS:
        print_ptxas(kern)
        smem = getattr(lib, f"qv_{entry}_smem")(None)
        print(f"{kern}: {smem} B of dynamic shared memory per block",
              flush=True)
        if entry in K.CLUSTERS:
            per_sm, clusters = ctypes.c_int(), ctypes.c_int()
            rc = getattr(lib, f"qv_{entry}_occupancy")(
                ctypes.byref(per_sm), ctypes.byref(clusters))
            ok = rc == 0 and per_sm.value >= K.CLUSTERS[entry]
            print(f"{kern}: clusters of 2 CTAs, "
                  f"{per_sm.value} CTAs resident per SM (expected "
                  f"{K.CLUSTERS[entry]}), {clusters.value} clusters at "
                  f"once, rc {rc}  {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                failed.append((kern, "occupancy"))
    if failed:
        raise AssertionError(f"n=64 training kernels disagree: {failed}")
    return n64_train_times(K, dev, lib)


def n64_train_times(K, dev, lib):
    """Phase (m): the device time of the four n=64 train-mode forwards
    (``N64_TRAIN_KERNELS[:4]``; the cross/tail one on clusters,
    ``K.CLUSTER_FWD``) and of the four cluster backwards
    (``K.CLUSTER_BWD``) at the train path's batch and at B=1024, with
    masks on (``kernels/time_bwd64.py``'s inputs); returns {(unit, B):
    the forward's device ms}."""
    import torch

    from qavit_tpu_torch.kernels import time_bwd64 as TB

    times = {}
    for b in (TIN_BATCH, TIN_TRAIN_BIG[0]):
        g, p, train, inputs, cots = TB.setup(TIN_PRESET, b, dev)
        grid = K.train_grid(dev, b)
        for unit in TB.UNITS:
            kern = csrc_kernel(K, unit, g, torch.bfloat16, train=True)
            ms = device_ms(TB.forward(lib, unit, g, p, train, inputs[unit],
                                      dev), 10, kern)
            entry = f"{unit}_mma_train64"
            launch = (f"{K.cluster_grid(entry, grid, b, dev).blocks} "
                      f"clusters of 2 CTAs" if entry in K.CLUSTER_FWD
                      else f"{grid.blocks} blocks")
            print(f"time {kern} (forward, train) B={b}: device {ms:.4f} ms, "
                  f"{launch}; card {card_line()}", flush=True)
            times[(unit, b)] = ms
        for unit in TB.UNITS:
            kern = csrc_kernel(K, unit, g, torch.bfloat16, True)
            ms = device_ms(TB.backward(lib, unit, g, p, train, inputs[unit],
                                       cots[unit], dev), 10, kern)
            clusters = K.cluster_grid(K.bwd_entry(unit, g, torch.bfloat16),
                                      K.train_grid(dev, b), b, dev).blocks
            print(f"time {kern} B={b}: device {ms:.4f} ms, {clusters} "
                  f"clusters of 2 CTAs; card {card_line()}", flush=True)
        del inputs, cots
        torch.cuda.empty_cache()
    return times


def n64_train_path(K, dev, g, p, fwd_times=None):
    """Phase (n): the hqavit_proc_tin train step through the bench CLI with
    the counts reset just before; a float32 step refused before any
    launch; the kernel step against the plain steps on the card; the
    step's time at two batches; each unit's wrapper check and timing at
    the path's batch (the record's @n64 train rows)."""
    import torch

    from qavit_tpu_torch.cli import bench
    from qavit_tpu_torch.configs import get_preset
    from qavit_tpu_torch.nn.models import build_model
    from qavit_tpu_torch.train.steps import loss_and_grads

    preset = get_preset(TIN_PRESET)
    cfg = preset.model
    reset_launches()
    row = bench.main(["--preset", TIN_PRESET, "--train", "--batch-sizes",
                      str(TIN_BATCH), "--steps", str(TRAIN_STEPS)])[0]
    launches = launch_counts()
    routes = dict(K.ROUTES)
    steps = TRAIN_STEPS + 1
    per = cfg.depth * steps
    print(f"n=64 train path ({TIN_PRESET}, {cfg.depth} blocks): {steps} "
          f"steps at B={TIN_BATCH}, losses {row['first_loss']:.4f} -> "
          f"{row['last_loss']:.4f}, bank count {row['bank_count']}, "
          f"launches {launches}", flush=True)
    print(f"n=64 train path: launches per C entry {routes}", flush=True)
    want = {n: 0 if n == "flash_attention" else per for n in launches}
    if launches != want:
        raise AssertionError(f"n=64 train path launches {launches}, "
                             f"expected {want}")
    want = {n: per if n.endswith(("_mma_train64", "_bwd_mma64")) else 0
            for n in routes}
    if routes != want:
        raise AssertionError(f"n=64 train path routes {routes}, expected "
                             f"{want} (every launch through its n=64 entry)")
    if row["bank_count"] != 3 * cfg.depth * steps:
        raise AssertionError(f"bank count {row['bank_count']} after {steps} "
                             f"steps, expected {3 * cfg.depth} per step")
    if not all(map(math.isfinite, (row["first_loss"], row["last_loss"]))):
        raise AssertionError(f"n=64 train losses not finite: {row}")
    # float32 on the card: refused with its reason before any launch
    mc32 = cfg.replace(dtype="float32")
    model = build_model(mc32, dev, seed=0)
    imgs = torch.randn(2, cfg.img_size, cfg.img_size, 3).to(dev)
    names = [n for n, _ in model.named_parameters()]
    K.reset_launches()
    try:
        loss_and_grads(model, names, imgs, torch.zeros(2, dtype=torch.long,
                                                       device=dev),
                       0, 0, mc32, preset.train)
        refused = ""
    except ValueError as e:
        refused = str(e)
    ok = "float32 at n=64 in training" in refused and not any(
        K.ROUTES.values())
    print(f"n=64 train step float32: refused before any launch {ok} "
          f"({refused[:120]})", flush=True)
    if not ok:
        raise AssertionError("a float32 n=64 train step was not refused")
    del model
    kernel_vs_plain_step(K, cfg, dev, TIN_PRESET, TIN_BATCH)
    torch.cuda.empty_cache()
    big_row = None
    for big in TIN_TRAIN_BIG:
        try:
            big_row = bench.main(["--preset", TIN_PRESET, "--train",
                                  "--batch-sizes", str(big), "--steps",
                                  str(TRAIN_STEPS)])[0]
            break
        except torch.cuda.OutOfMemoryError:
            print(f"n=64 train step at B={big}: out of memory", flush=True)
            torch.cuda.empty_cache()
    if big_row is None:
        raise AssertionError(f"no n=64 train step fits at {TIN_TRAIN_BIG}")
    for r in (row, big_row):
        print(f"n=64 train step: {r['ms_per_step']:.3f} ms per step of "
              f"{r['batch']}, {r['img_per_s']:.1f} img/s (CUDA events, "
              f"bf16, {r['steps']} steps after one warm-up), peak memory "
              f"{r['max_memory_allocated'] / 2 ** 30:.2f} GiB; card "
              f"{card_line()}", flush=True)
    rows = train_unit_checks_and_timing(K, cfg, g, p, dev, launches,
                                        TIN_BATCH, "@n64")
    for unit in K.UNITS:     # the forwards' device time at B=1024, phase (m)
        ms = (fwd_times or {}).get((unit, TIN_TRAIN_BIG[0]))
        for row in rows:
            if row["name"] == (f"{record_name(K, unit, g, torch.bfloat16)}"
                               "_train@n64") and ms is not None:
                row[f"device_ms_b{TIN_TRAIN_BIG[0]}"] = ms
    return rows


def augment_checks(A, aug, images, dev):
    """Phase (o) step 2: ``augment_batch`` on the card at each of
    DATA_BATCHES; returns {B: ms per batch}."""
    import torch

    def seeded(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    times = {}
    for b in DATA_BATCHES:
        x = images[:b]
        runs = [A.augment_batch(x, aug, seeded(s)) for s in (0, 0, 1)]
        out = runs[0]
        params = A.draw_params(aug, b, seeded(0))
        on_card = A.apply_augment(x, params, aug)
        on_cpu = A.apply_augment(x.cpu(), {k: v.cpu() for k, v in
                                           params.items()}, aug)
        err = (on_card.cpu() - on_cpu).abs().max().item()
        gen = seeded(2)
        times[b] = cuda_ms(lambda: A.augment_batch(x, aug, gen), iters=20)
        busy = device_ms(lambda: A.augment_batch(x, aug, gen), iters=3)
        ok = {"finite": bool(torch.isfinite(out).all()),
              "shape": tuple(out.shape) == (b, 32, 32, 3),
              "same seed, same bits": torch.equal(runs[0], runs[1]),
              "other seed differs": not torch.equal(runs[0], runs[2]),
              "card vs CPU": err <= AUG_TOLERANCE,
              "on the images' device": out.device == x.device}
        print(f"augment proc100_hard_hqa B={b}: {times[b]:.3f} ms per batch "
              f"(CUDA events, 20 after a warm-up), the device busy "
              f"{busy if busy is None else round(busy, 3)} ms of it "
              f"(torch.profiler), card vs CPU with the same "
              f"parameters max_abs_err {err:.3e} (tolerance "
              f"{AUG_TOLERANCE:.0e}), checks {ok}; card {card_line()}",
              flush=True)
        if not all(ok.values()):
            raise AssertionError(f"augment_batch at B={b} failed: {ok}")
    return times


def data_train(K, dev, preset, aug, images, labels, batch, aug_ms):
    """Phase (o) step 3: the train step on device-resident data through
    IndexLoader + augment_batch, the counts reset just before."""
    import torch

    from torch.profiler import ProfilerActivity, profile

    from qavit_tpu_torch.data import augment as A
    from qavit_tpu_torch.data.loader import IndexLoader
    from qavit_tpu_torch.nn.models import build_model
    from qavit_tpu_torch.train.optim import make_schedule
    from qavit_tpu_torch.train.state import create_train_state
    from qavit_tpu_torch.train.steps import make_train_step

    cfg, tc = preset.model, preset.train
    torch.cuda.reset_peak_memory_stats(dev)
    state = create_train_state(build_model(cfg, dev, seed=0), tc.use_ema,
                               tc.ema_decay)
    loader = IndexLoader(len(labels), batch, seed=0, device=dev)
    step = make_train_step(cfg, tc, make_schedule(tc, len(loader)))
    gen = torch.Generator(device=dev).manual_seed(0)
    batches = iter(loader)

    def one():
        idx = next(batches)
        return step(state, A.augment_batch(images[idx], aug, gen),
                    labels[idx], 0)["loss"]

    reset_launches()
    losses = [one()]                                  # warm-up
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    losses += [one() for _ in range(DATA_STEPS)]
    e1.record()
    torch.cuda.synchronize()
    ms = e0.elapsed_time(e1) / DATA_STEPS
    launches, routes = launch_counts(), dict(K.ROUTES)
    steps = DATA_STEPS + 1
    per = cfg.depth * steps
    losses = [float(v) for v in losses]
    bank = int(state.bank_count)
    # the same steps on one augmented batch: the step without augmentation
    idx = next(batches)
    x, y = A.augment_batch(images[idx], aug, gen), labels[idx]
    plain_ms = cuda_ms(lambda: step(state, x, y, 0), iters=DATA_STEPS,
                       warmup=1)
    mem = torch.cuda.max_memory_allocated(dev)
    if batch == max(DATA_BATCHES):
        # one step with augmentation traced: the device's busy and idle
        # time (at the largest batch only: a trace of ~10^4 launches
        # takes seconds to read)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            one()
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
        rows = device_kernels(prof)
        busy = sum(r[1] for r in rows)
        top = [(n[:48], round(ms, 2), c) for n, ms, c in rows[:6]]
        print(f"data train step B={batch}, one step traced "
              f"(torch.profiler): the device busy {busy:.1f} ms of "
              f"{wall:.1f} ms, idle share {1 - busy / wall:.3f}; longest "
              f"kernels {top}", flush=True)
    print(f"data train path ({DATA_PRESET}, bf16, B={batch}): {steps} "
          f"steps, losses {losses}, bank count {bank}, launches {launches}",
          flush=True)
    print(f"data train path: launches per C entry {routes}", flush=True)
    print(f"data train step B={batch}: {ms:.3f} ms per step with "
          f"augmentation, {plain_ms:.3f} ms without, augmentation alone "
          f"{aug_ms:.3f} ms ({100 * aug_ms / ms:.1f}% of the step), "
          f"{1000 * batch / ms:.1f} img/s, peak memory {mem / 2 ** 30:.2f} "
          f"GiB (CUDA events, {DATA_STEPS} steps after one warm-up); card "
          f"{card_line()}", flush=True)
    want = {n: 0 if n == "flash_attention" else per for n in launches}
    if launches != want:
        raise AssertionError(f"data train path launches {launches}, "
                             f"expected {want}")
    mma = {f"{u}_mma" for u in MMA_BWD} | {f"{u}_bwd_mma" for u in MMA_BWD}
    want = {n: per if n in mma else 0 for n in routes}
    if routes != want:
        raise AssertionError(f"data train path routes {routes}, expected "
                             f"{want} (every launch through its n=16 "
                             f"tensor-core entry)")
    if bank != 3 * cfg.depth * steps:
        raise AssertionError(f"bank count {bank} after {steps} steps, "
                             f"expected {3 * cfg.depth} per step")
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"data train losses not finite: {losses}")
    return ms, plain_ms, mem


def data_path(K, dev, root):
    """Phase (o): generate proc100_hard into ``root``, augment it on the
    card, train on it, evaluate its val split through the CLI."""
    import hashlib

    import numpy as np
    import torch

    from qavit_tpu_torch.cli import evaluate
    from qavit_tpu_torch.configs import get_preset
    from qavit_tpu_torch.data import augment as A
    from qavit_tpu_torch.data.datasets import load_dataset
    from qavit_tpu_torch.data.pipelines import get_pipeline
    from qavit_tpu_torch.data.procgen import load_or_generate_proc100_hard

    t_phase = time.perf_counter()
    preset = get_preset(DATA_PRESET)
    pipe = get_pipeline(preset.dataset)
    say(f"phase (o) step 1: load_dataset({pipe.base_dataset!r}) into a "
        f"temporary root")
    t = time.perf_counter()
    load_or_generate_proc100_hard(root, *DATA_SPLITS)
    ds = load_dataset(pipe.base_dataset, root)
    gen_s = time.perf_counter() - t
    digest = hashlib.sha256(ds.test_images.tobytes()
                            + ds.test_labels.tobytes()).hexdigest()
    counts = np.bincount(ds.train_labels, minlength=ds.num_classes)
    print(f"data: generated and cached in {gen_s:.1f} s: train "
          f"{ds.train_images.shape} {ds.train_images.dtype}, val "
          f"{ds.test_images.shape} {ds.test_images.dtype}, labels "
          f"{ds.train_labels.dtype} in [{ds.train_labels.min()}, "
          f"{ds.train_labels.max()}], class counts {counts.min()}-"
          f"{counts.max()}, val sha256 {digest}", flush=True)
    ok = (ds.train_images.shape == (DATA_SPLITS[0], 32, 32, 3)
          and ds.test_images.shape == (DATA_SPLITS[1], 32, 32, 3)
          and ds.train_images.dtype == ds.test_images.dtype == np.uint8
          and ds.train_labels.dtype == ds.test_labels.dtype == np.int32
          and 0 <= min(ds.train_labels.min(), ds.test_labels.min())
          and max(ds.train_labels.max(), ds.test_labels.max()) < 100
          and not ds.synthetic)
    if not ok:
        raise AssertionError("proc100_hard: unexpected shapes, dtypes or "
                             "labels")
    # device-resident, as JAX keeps a dataset of 2 GiB or less
    images = torch.from_numpy(ds.train_images).to(dev)
    labels = torch.from_numpy(ds.train_labels).long().to(dev)
    say("phase (o) step 2: augment_batch on the card")
    aug_ms = augment_checks(A, pipe.aug, images, dev)
    say("phase (o) step 3: train on augmented batches")
    for b in DATA_BATCHES:
        data_train(K, dev, preset, pipe.aug, images, labels, b,
                   aug_ms[b])
        torch.cuda.empty_cache()
    del images, labels
    say("phase (o) step 4: cli.evaluate over the val split")
    reset_launches()
    r = evaluate.main(["--preset", DATA_PRESET, "--data-root", root,
                       "--batch-size", str(DATA_EVAL_BATCH)])
    launches = launch_counts()
    print(f"data eval: {r['count']} images, top-1 {r['top1']:.2f}% "
          f"(seed weights), top-5 {r['top5']:.2f}%, loss "
          f"{r['loss']:.4f}, {r['img_per_s']:.1f} img/s (host clock); "
          f"launches {launches}; card {card_line()}", flush=True)
    if not (r["count"] == DATA_SPLITS[1] and math.isfinite(r["loss"])):
        raise AssertionError(f"data eval result out of range: {r}")
    # the smoke forward, one untimed batch per shape, the batches
    forwards = 1 + 2 + math.ceil(DATA_SPLITS[1] / DATA_EVAL_BATCH)
    for name, n in launches.items():
        want = preset.model.depth * forwards if name in K.UNITS else 0
        if n != want:
            raise AssertionError(f"data eval {name}: {n} launches, "
                                 f"expected {want}")
    print(f"phase (o): {time.perf_counter() - t_phase:.1f} s", flush=True)


def _state_tensors(state) -> dict:
    """Every tensor of a train state that a resume must restore."""
    named = dict(state.model.named_parameters())
    out = {f"param {n}": named[n].detach() for n in state.names}
    out.update({f"buffer {n}": b for n, b in
                state.model.named_buffers()})
    out.update({f"mu {n}": t for n, t in zip(state.names, state.opt.mu)})
    out.update({f"nu {n}": t for n, t in zip(state.names, state.opt.nu)})
    out.update({f"ema {n}": t for n, t in state.ema_params.items()})
    out["bank_count"] = state.bank_count
    return out


def _run_distance(a, b) -> float:
    """The largest difference of two runs' state tensors, each relative
    to its tensor's largest |value| (losses included)."""
    worst = 0.0
    for k in a:
        x, y = a[k].double(), b[k].double()
        scale = max(x.abs().max().item(), 1e-12)
        worst = max(worst, (x - y).abs().max().item() / scale)
    return worst


def resume_check(dev, root):
    """Phase (p) step 2: RESUME_STEPS uninterrupted steps (twice) against
    half of them, save_train_state, restore_train_state into a freshly
    built state, then the other half, all from the same weights and
    batches; returns the two distances."""
    import torch

    from qavit_tpu_torch.ckpt.checkpoint import (restore_train_state,
                                                 save_train_state)
    from qavit_tpu_torch.cli.train import aug_seed
    from qavit_tpu_torch.configs import get_preset
    from qavit_tpu_torch.data import augment as A
    from qavit_tpu_torch.data.datasets import load_dataset
    from qavit_tpu_torch.data.pipelines import get_pipeline
    from qavit_tpu_torch.nn.models import build_model
    from qavit_tpu_torch.train.optim import make_schedule
    from qavit_tpu_torch.train.state import create_train_state
    from qavit_tpu_torch.train.steps import make_train_step

    preset = get_preset(DATA_PRESET)
    cfg, tc = preset.model, preset.train
    pipe = get_pipeline(preset.dataset)
    ds = load_dataset(pipe.base_dataset, root)
    b = tc.batch_size
    images = torch.from_numpy(ds.train_images[:RESUME_STEPS * b]).to(dev)
    labels = torch.from_numpy(ds.train_labels[:RESUME_STEPS * b]).long()
    batches = [(A.augment_batch(
        images[i * b:(i + 1) * b], pipe.aug,
        torch.Generator(device=dev).manual_seed(aug_seed(tc.seed + 1, i))),
        labels[i * b:(i + 1) * b].to(dev)) for i in range(RESUME_STEPS)]
    step = make_train_step(cfg, tc, make_schedule(tc, 195))

    def fresh():
        return create_train_state(build_model(cfg, dev, seed=tc.seed),
                                  tc.use_ema, tc.ema_decay)

    def run(state, lo, hi):
        return [step(state, *batches[i], tc.seed + 1)["loss"]
                for i in range(lo, hi)]

    def record(state, losses):
        out = {k: v.clone() for k, v in _state_tensors(state).items()}
        out["losses"] = torch.stack([x.float() for x in losses])
        return out

    t0 = time.perf_counter()
    runs = []
    for _ in range(2):
        state = fresh()
        runs.append(record(state, run(state, 0, RESUME_STEPS)))
    half = RESUME_STEPS // 2
    state = fresh()
    losses = run(state, 0, half)
    with tempfile.TemporaryDirectory(prefix="qv_resume_") as ck:
        t = time.perf_counter()
        nbytes = save_train_state(ck, state, cfg, tc)
        save_s = time.perf_counter() - t
        del state
        t = time.perf_counter()
        state, _ = restore_train_state(ck, fresh())
        load_s = time.perf_counter() - t
    losses += run(state, half, RESUME_STEPS)
    resumed = record(state, losses)
    torch.cuda.synchronize()
    d_ref = _run_distance(runs[0], runs[1])
    d_res = _run_distance(runs[0], resumed)
    bank = int(state.bank_count)
    print(f"resume on the card ({DATA_PRESET}, bf16, B={b}): "
          f"{RESUME_STEPS} steps uninterrupted twice, and {half} + save + "
          f"restore into a fresh state + {RESUME_STEPS - half}; losses "
          f"{[round(float(x), 6) for x in runs[0]['losses']]} and "
          f"{[round(float(x), 6) for x in resumed['losses']]}; distance "
          f"(largest |difference| over parameters, buffers, moments, EMA, "
          f"bank count and losses, relative to each tensor's max) "
          f"uninterrupted vs uninterrupted {d_ref:.3e}, resumed vs "
          f"uninterrupted {d_res:.3e} (limit {RESUME_FACTOR} x "
          f"{d_ref:.3e} + {RESUME_SLACK:.0e}); checkpoint {nbytes / 1e6:.1f}"
          f" MB saved in {save_s:.2f} s, restored in {load_s:.2f} s; bank "
          f"count {bank}; {time.perf_counter() - t0:.1f} s", flush=True)
    if d_res > RESUME_FACTOR * d_ref + RESUME_SLACK:
        raise AssertionError(f"the resumed run is {d_res:.3e} from the "
                             f"uninterrupted one, two uninterrupted runs "
                             f"{d_ref:.3e} from each other")
    if bank != 3 * cfg.depth * RESUME_STEPS:
        raise AssertionError(f"bank count {bank} after the resumed run")
    return d_ref, d_res


def train_loop_path(K, dev, root):
    """Phase (p): ``cli.train`` for LOOP_EPOCHS epochs of LOOP_STEPS steps
    on phase (o)'s proc100_hard, the resume check, and ``cli.evaluate
    --checkpoint ... --tta`` on its best_model; returns a copy of that
    best_model under ``root`` (phase (q) starts from it)."""
    import shutil
    from pathlib import Path

    import torch

    from qavit_tpu_torch.cli import evaluate
    from qavit_tpu_torch.cli import train as cli_train
    from qavit_tpu_torch.configs import get_preset
    from qavit_tpu_torch.obs.metrics import BASE_KEYS, EMA_KEYS

    t_phase = time.perf_counter()
    preset = get_preset(DATA_PRESET)
    cfg, tc = preset.model, preset.train
    mma_fwd = {f"{u}_mma" for u in MMA_BWD}
    mma_bwd = {f"{u}_bwd_mma" for u in MMA_BWD}
    with tempfile.TemporaryDirectory(prefix="qv_train_") as out:
        ck, lg = Path(out) / "ck", Path(out) / "lg"
        say("phase (p) step 1: cli.train")
        reset_launches()
        t = time.perf_counter()
        best = cli_train.main([
            "--preset", DATA_PRESET, "--data-root", root, "--epochs",
            str(LOOP_EPOCHS), "--max-steps-per-epoch", str(LOOP_STEPS),
            "--checkpoint-dir", str(ck), "--log-dir", str(lg)])
        train_s = time.perf_counter() - t
        launches, routes = launch_counts(), dict(K.ROUTES)
        d = json.loads((lg / "training_metrics.json").read_text())
        h = d["history"]
        steps = LOOP_EPOCHS * LOOP_STEPS
        forwards = LOOP_EPOCHS * 2 * math.ceil(
            DATA_SPLITS[1] / (tc.eval_batch_size or 2 * tc.batch_size))
        fwd = cfg.depth * (steps + forwards)
        bwd = cfg.depth * steps
        saved = {n: json.loads((ck / n / "meta.json").read_text())
                 for n in ("best_model", "best_model_ema")
                 if (ck / n / "meta.json").exists()}
        ema_file = ck / "best_model_ema" / "state.pt"
        tree = (torch.load(ema_file, map_location="cpu", weights_only=True)
                if ema_file.exists() else {"step": -1, "bank_count": 0})
        print(f"train loop: {LOOP_EPOCHS} epochs x {LOOP_STEPS} steps in "
              f"{train_s:.1f} s (host clock, the data read from phase "
              f"(o)'s cache, {LOOP_EPOCHS * 2} passes over the val split "
              f"included); best val {best:.2f}; history {h}; saved "
              f"{ {n: m['metrics'] for n, m in saved.items()} }; "
              f"best_model_ema at step {tree['step']}, bank count "
              f"{int(tree['bank_count'])}; launches {launches}", flush=True)
        print(f"train loop: launches per C entry {routes}", flush=True)
        ok = {"keys": sorted(h) == sorted(BASE_KEYS + EMA_KEYS)
              and sorted(d) == ["best_val_acc", "history", "total_time"],
              "epochs": h["epoch"] == list(range(1, LOOP_EPOCHS + 1)),
              "finite": all(math.isfinite(v) for k in h for v in h[k])
              and all(len(h[k]) == LOOP_EPOCHS for k in h),
              "best_model and best_model_ema": sorted(saved) == [
                  "best_model", "best_model_ema"],
              "bank count": int(tree["bank_count"]) == 3 * cfg.depth
              * tree["step"],
              "launches": launches == {n: fwd if n in K.UNITS else bwd
                                       if n.endswith("_bwd") else 0
                                       for n in launches},
              "routes": routes == {n: fwd if n in mma_fwd else bwd
                                   if n in mma_bwd else 0 for n in routes}}
        print(f"train loop checks {ok}", flush=True)
        if not all(ok.values()):
            raise AssertionError(f"cli.train failed its checks: {ok}")

        say("phase (p) step 2: resume on the card")
        t = time.perf_counter()
        resume_check(dev, root)
        resume_s = time.perf_counter() - t
        torch.cuda.empty_cache()

        say("phase (p) step 3: cli.evaluate --checkpoint --tta")
        reset_launches()
        t = time.perf_counter()
        r = evaluate.main(["--preset", DATA_PRESET, "--data-root", root,
                           "--checkpoint", str(ck / "best_model"), "--tta",
                           "--batches", str(TTA_BATCHES), "--batch-size",
                           str(DATA_EVAL_BATCH)])
        eval_s = time.perf_counter() - t
        launches, routes = launch_counts(), dict(K.ROUTES)
        # the smoke, one untimed batch, the batches, five views of each
        forwards = 1 + 1 + TTA_BATCHES + 5 * TTA_BATCHES
        print(f"eval --tta: top-1 {r['top1']:.2f}%, TTA top-1 "
              f"{r['tta_top1']:.2f}% over {r['count']} images ({r['count']} "
              f"x 5 views in {r['tta_seconds']:.2f} s, host clock); "
              f"launches {launches}; card {card_line()}", flush=True)
        want = {n: cfg.depth * forwards if n in K.UNITS else 0
                for n in launches}
        want_routes = {n: cfg.depth * forwards if n in mma_fwd else 0
                       for n in routes}
        if not (math.isfinite(r["tta_top1"]) and 0 <= r["tta_top1"] <= 100
                and launches == want and routes == want_routes):
            raise AssertionError(f"cli.evaluate --tta: {r}, launches "
                                 f"{launches} (expected {want}), routes "
                                 f"{routes}")
        best = Path(root) / "p_best_model"
        shutil.copytree(ck / "best_model", best)
    print(f"phase (p): cli.train {train_s:.1f} s, resume check "
          f"{resume_s:.1f} s, cli.evaluate --tta {eval_s:.1f} s, in all "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return best


def _opt_tensors(state) -> dict:
    """A state's parameters, moments (the flat ones split per tensor) and
    EMA, by kind and name."""
    from qavit_tpu_torch.train.flat_optim import FlatAdamState

    params = state.params()
    mu, nu = state.opt.mu, state.opt.nu
    if isinstance(state.opt, FlatAdamState):
        mu, nu = state.opt.split(mu, params), state.opt.split(nu, params)
    return {("param", n): p.detach().clone()
            for n, p in zip(state.names, params)} | {
        ("mu", n): t.clone() for n, t in zip(state.names, mu)} | {
        ("nu", n): t.clone() for n, t in zip(state.names, nu)} | {
        ("ema", n): t.clone() for n, t in state.ema_params.items()}


def _floored_distance(a, b):
    """The largest difference of two runs' tensors, each relative to the
    larger of its max and FLAT_FLOOR x the largest of its kind in ``a``;
    returns it with the tensor's key."""
    top = {}
    for (kind, _), t in a.items():
        top[kind] = max(top.get(kind, 0.0), t.abs().max().item())
    worst, where = 0.0, None
    for k in a:
        x, y = a[k].double(), b[k].double()
        scale = max(x.abs().max().item(), FLAT_FLOOR * top[k[0]], 1e-30)
        d = (x - y).abs().max().item() / scale
        if d > worst:
            worst, where = d, k
    return worst, where


def flat_checks(dev, root):
    """Phase (q) steps 2-3: FLAT_STEPS bf16 steps of DATA_PRESET from the
    same weights and batches with the flat optimizer, per tensor, and per
    tensor from weights one ulp away, held as FLAT_STEP1 and FLAT_FACTOR
    say; then each setting's median step over FLAT_TIMED steps by CUDA
    events."""
    import statistics

    import torch

    from qavit_tpu_torch.cli.train import aug_seed
    from qavit_tpu_torch.configs import get_preset
    from qavit_tpu_torch.data import augment as A
    from qavit_tpu_torch.data.datasets import load_dataset
    from qavit_tpu_torch.data.pipelines import get_pipeline
    from qavit_tpu_torch.nn.models import build_model
    from qavit_tpu_torch.train.optim import make_schedule
    from qavit_tpu_torch.train.state import create_train_state
    from qavit_tpu_torch.train.steps import make_train_step

    preset = get_preset(DATA_PRESET)
    cfg, tc = preset.model, preset.train
    pipe = get_pipeline(preset.dataset)
    ds = load_dataset(pipe.base_dataset, root)
    b = tc.batch_size
    images = torch.from_numpy(ds.train_images[:FLAT_STEPS * b]).to(dev)
    labels = torch.from_numpy(ds.train_labels[:FLAT_STEPS * b]).long()
    batches = [(A.augment_batch(
        images[i * b:(i + 1) * b], pipe.aug,
        torch.Generator(device=dev).manual_seed(aug_seed(tc.seed + 1, i))),
        labels[i * b:(i + 1) * b].to(dev)) for i in range(FLAT_STEPS)]

    def run(flat, steps, ulp=0.0):
        """(tensors after step 1 and after FLAT_STEPS steps, each step's
        ms by CUDA events); with ``ulp`` +-inf the weights start one
        float32 ulp that way."""
        tcf = tc.replace(flat_optimizer=flat)
        step = make_train_step(cfg, tcf, make_schedule(tcf, 195))
        model = build_model(cfg, dev, seed=tc.seed)
        if ulp:
            with torch.no_grad():
                for p in model.parameters():
                    p.copy_(torch.nextafter(p, torch.full_like(p, ulp)))
        state = create_train_state(model, tc.use_ema, tc.ema_decay,
                                   flat=flat)
        snaps, ms = {}, []
        for i in range(steps):
            x, y = batches[i % FLAT_STEPS]
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            step(state, x, y, tc.seed + 1)
            t1.record()
            torch.cuda.synchronize()
            ms.append(t0.elapsed_time(t1))
            if i + 1 in (1, FLAT_STEPS):
                snaps[i + 1] = _opt_tensors(state)
        return snaps[1], snaps[FLAT_STEPS], ms

    t0 = time.perf_counter()
    tree1, tree, ms_tree = run(False, FLAT_TIMED + 1)
    d_ulp, at_ulp = max(_floored_distance(tree, run(False, FLAT_STEPS,
                                                    ulp=u)[1])
                        for u in (math.inf, -math.inf))
    flat1, flat, ms_flat = run(True, FLAT_TIMED + 1)
    d1, at1 = _floored_distance(tree1, flat1)
    d, at = _floored_distance(tree, flat)
    limit = FLAT_FACTOR * d_ulp + FLAT_STEP1
    print(f"flat optimizer on the card ({DATA_PRESET}, bf16, B={b}), from "
          f"the same weights and batches; distance (largest |difference| "
          f"over parameters, both moments and the EMA, relative to the "
          f"larger of the tensor's max and {FLAT_FLOOR} x the largest of its "
          f"kind): after step 1 flat vs per-tensor {d1:.3e} at {at1} "
          f"(limit {FLAT_STEP1:.0e}); after {FLAT_STEPS} steps flat vs "
          f"per-tensor {d:.3e} at {at}, per-tensor vs per-tensor from "
          f"weights one ulp away (the larger of up and down) {d_ulp:.3e} "
          f"at {at_ulp} (limit {FLAT_FACTOR} x {d_ulp:.3e} + "
          f"{FLAT_STEP1:.0e}); {time.perf_counter() - t0:.1f} s", flush=True)
    if d1 > FLAT_STEP1 or d > limit:
        raise AssertionError(f"the flat optimizer's run is {d1:.3e} after "
                             f"one step ({at1}) and {d:.3e} after "
                             f"{FLAT_STEPS} ({at}) from the per-tensor one")
    medians = {}
    for flag, ms in ((False, ms_tree[1:]), (True, ms_flat[1:])):
        medians[flag] = statistics.median(ms)
        print(f"train step ({DATA_PRESET}, bf16, B={b}, "
              f"flat_optimizer={flag}): median {medians[flag]:.2f} ms over "
              f"{FLAT_TIMED} steps after one warm-up (CUDA events), "
              f"range {min(ms):.2f}-{max(ms):.2f}", flush=True)
    print(f"finding: the flat optimizer's step {medians[True]:.2f} ms "
          f"against {medians[False]:.2f} ms per tensor (no gate); card "
          f"{card_line()}", flush=True)


def finetune_path(K, dev, root, init):
    """Phase (q): ``cli.train --preset FT_PRESET --init-from <phase (p)'s
    best_model> --grad-accum FT_ACCUM --debug-grads`` for LOOP_EPOCHS
    epochs of LOOP_STEPS steps on phase (o)'s data, then
    :func:`flat_checks`."""
    import io
    from pathlib import Path

    import torch

    from qavit_tpu_torch.cli import train as cli_train
    from qavit_tpu_torch.configs import get_preset
    from qavit_tpu_torch.train.optim import make_schedule

    t_phase = time.perf_counter()
    preset = get_preset(FT_PRESET)
    cfg, tc = preset.model, preset.train
    mma_fwd = {f"{u}_mma" for u in MMA_BWD}
    mma_bwd = {f"{u}_bwd_mma" for u in MMA_BWD}
    with tempfile.TemporaryDirectory(prefix="qv_ft_") as out:
        ck, lg = Path(out) / "ck", Path(out) / "lg"
        say("phase (q) step 1: cli.train --grad-accum --debug-grads")
        reset_launches()
        text = io.StringIO()
        t = time.perf_counter()
        try:
            with contextlib.redirect_stdout(text):
                best = cli_train.main([
                    "--preset", FT_PRESET, "--data-root", root,
                    "--init-from", str(init), "--epochs", str(LOOP_EPOCHS),
                    "--max-steps-per-epoch", str(LOOP_STEPS),
                    "--grad-accum", str(FT_ACCUM), "--debug-grads",
                    "--checkpoint-dir", str(ck), "--log-dir", str(lg)])
        except BaseException:
            print(text.getvalue()[-6000:], flush=True)
            raise
        train_s = time.perf_counter() - t
        launches, routes = launch_counts(), dict(K.ROUTES)
        log = text.getvalue()
        table = [ln for ln in log.splitlines()
                 if ln.startswith("LR groups") or ln.startswith("  x")]
        tops = [ln.strip() for ln in log.splitlines()
                if "top grad layers:" in ln]
        for line in table + tops[-1:] + [
                ln for ln in log.splitlines() if ln.startswith("transfer")]:
            print(f"finetune: {line}", flush=True)
        h = json.loads((lg / "training_metrics.json").read_text())["history"]
        sched = make_schedule(tc.replace(epochs=LOOP_EPOCHS), LOOP_STEPS)
        want_lr = [sched(e * LOOP_STEPS) for e in h["epoch"]]
        micro = LOOP_EPOCHS * LOOP_STEPS * FT_ACCUM
        forwards = LOOP_EPOCHS * 2 * math.ceil(
            DATA_SPLITS[1] / (tc.eval_batch_size or 2 * tc.batch_size))
        fwd, bwd = cfg.depth * (micro + forwards), cfg.depth * micro
        ema_file = ck / "best_model_ema" / "state.pt"
        tree = (torch.load(ema_file, map_location="cpu", weights_only=True)
                if ema_file.exists() else {"step": -1, "bank_count": 0})
        print(f"finetune: {LOOP_EPOCHS} epochs x {LOOP_STEPS} steps of "
              f"{FT_ACCUM} micro-batches in {train_s:.1f} s (host clock); "
              f"best val {best:.2f}; lr {h['lr']} (make_schedule "
              f"{want_lr}); history {h}; launches {launches}; per C entry "
              f"{routes}", flush=True)
        ok = {"lr groups table": len(table) > 2
              and table[0] == "LR groups (layerwise):",
              "top grad layers": len(tops) == LOOP_EPOCHS,
              "lr": h["lr"] == want_lr,
              "finite": all(math.isfinite(v) for k in h for v in h[k]),
              "bank count": int(tree["bank_count"]) == 3 * cfg.depth
              * FT_ACCUM * tree["step"],
              "launches": launches == {n: fwd if n in K.UNITS else bwd
                                       if n.endswith("_bwd") else 0
                                       for n in launches},
              "routes": routes == {n: fwd if n in mma_fwd else bwd
                                   if n in mma_bwd else 0 for n in routes}}
        print(f"finetune checks {ok}", flush=True)
        if not all(ok.values()):
            raise AssertionError(f"cli.train (finetune) failed its checks: "
                                 f"{ok}")
    torch.cuda.empty_cache()
    say("phase (q) step 2: flat optimizer against per-tensor, and times")
    t = time.perf_counter()
    flat_checks(dev, root)
    print(f"phase (q): cli.train {train_s:.1f} s, flat checks "
          f"{time.perf_counter() - t:.1f} s, in all "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)


def flat_train_path(K, dev, root):
    """Phase (r): the flat QAViT's train step on both routes.  Route A,
    qavit_v2_extreme_proc100 under ``attn_impl="fused_block"`` (C=192,
    depth 8, n=64 in four windows, bf16, B=256): the kernel step against
    the plain step (``kernel_vs_plain_step``, at CHECK_DEPTH blocks) with
    every launch count set to 0 just before, each unit's forward and
    backward kernel once a block a step through its n=64 train entry;
    then ``cli.train --attn-impl fused_block`` for 2 epochs x
    FLAT64_STEPS steps on a proc100 cut to FLAT64_SPLITS (8 launches of
    each a step), a checkpoint every epoch, and ``--resume`` from epoch
    1's.  Route B, qavit_224_v1_proc on the branch path: ``cli.bench
    --train --batch-sizes 256`` with the counts reset just before (no
    kernel launch: training with dropout keeps every attention plain, as
    JAX does), a finite loss, ms a step and the peak memory."""
    import io
    from pathlib import Path

    import torch

    from qavit_tpu_torch.cli import bench
    from qavit_tpu_torch.cli import train as cli_train
    from qavit_tpu_torch.configs import get_preset
    from qavit_tpu_torch.configs import presets as P
    from qavit_tpu_torch.data.procgen import load_or_generate_proc100

    t_phase = time.perf_counter()
    preset = get_preset(FLAT64_PRESET)
    cfg = preset.model.replace(attn_impl="fused_block")
    train64 = {f"{u}_mma_train64" for u in MMA_BWD}
    eval64 = {f"{u}_mma" for u in MMA_BWD}
    bwd64 = {f"{u}_bwd_mma64" for u in MMA_BWD}

    say("phase (r) step 1: route A, kernel step vs plain step")
    reset_launches()
    kernel_vs_plain_step(K, cfg, dev, FLAT64_PRESET, FLAT64_BATCH)
    launches, routes = launch_counts(), dict(K.ROUTES)
    # the gradients' step and the steps, at the checks' depth
    per = check_depth(cfg).depth * (1 + BF16_STEPS)
    print(f"flat n=64 kernel steps ({FLAT64_PRESET}, fused_block, "
          f"{check_depth(cfg).depth} blocks, B={FLAT64_BATCH}): launches "
          f"{launches}; "
          f"per C entry {routes}", flush=True)
    want = {n: 0 if n == "flash_attention" else per for n in launches}
    want_routes = {n: per if n in train64 | bwd64 else 0 for n in routes}
    if launches != want or routes != want_routes:
        raise AssertionError(f"route A launches {launches}, routes "
                             f"{routes}, expected {want}, {want_routes} "
                             f"(one a block a step each, n=64 entries)")
    torch.cuda.empty_cache()

    say("phase (r) step 2: route A, cli.train --attn-impl fused_block")
    t = time.perf_counter()
    load_or_generate_proc100(root, *FLAT64_SPLITS)
    gen_s = time.perf_counter() - t
    cut = P.Preset(preset.model, preset.train.replace(save_freq=1),
                   preset.dataset)
    with tempfile.TemporaryDirectory(prefix="qv_flat_") as out, \
            mock.patch.dict(P.PRESETS, {FLAT64_PRESET: lambda: cut}):
        ck, lg = Path(out) / "ck", Path(out) / "lg"
        args = ["--preset", FLAT64_PRESET, "--attn-impl", "fused_block",
                "--data-root", root, "--batch-size", str(FLAT64_BATCH),
                "--max-steps-per-epoch",
                str(FLAT64_STEPS), "--checkpoint-dir", str(ck),
                "--log-dir", str(lg)]
        reset_launches()
        t = time.perf_counter()
        cli_train.main(args + ["--epochs", "2"])
        train_s = time.perf_counter() - t
        launches, routes = launch_counts(), dict(K.ROUTES)
        h = json.loads((lg / "training_metrics.json").read_text())[
            "history"]
        steps = 2 * FLAT64_STEPS
        val = 2 * math.ceil(FLAT64_SPLITS[1] / (2 * FLAT64_BATCH))
        fwd, bwd = cfg.depth * steps, cfg.depth * steps
        print(f"flat n=64 cli.train: 2 epochs x {FLAT64_STEPS} steps in "
              f"{train_s:.1f} s (host clock; proc100 {FLAT64_SPLITS} "
              f"generated in {gen_s:.1f} s); history {h}; launches "
              f"{launches}; per C entry {routes}", flush=True)
        want = {n: (fwd + cfg.depth * val if n in K.UNITS else bwd
                    if n.endswith("_bwd") else 0) for n in launches}
        want_routes = {n: fwd if n in train64 else cfg.depth * val
                       if n in eval64 else bwd if n in bwd64 else 0
                       for n in routes}
        ok = {"epochs": h["epoch"] == [1, 2],
              "finite": all(math.isfinite(v) for k in h for v in h[k]),
              "launches": launches == want, "routes": routes == want_routes}
        print(f"flat n=64 cli.train checks {ok}", flush=True)
        if not all(ok.values()):
            raise AssertionError(f"route A cli.train: {ok}, launches "
                                 f"{launches} (expected {want}), routes "
                                 f"{routes} (expected {want_routes})")
        t = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli_train.main(args + ["--epochs", "3", "--resume",
                                   str(ck / "checkpoint_epoch_1")])
        resume_s = time.perf_counter() - t
        log = buf.getvalue()
        h = json.loads((lg / "training_metrics.json").read_text())[
            "history"]
        tree = torch.load(ck / "checkpoint_epoch_3" / "state.pt",
                          map_location="cpu", weights_only=True)
        ok = {"resumed at epoch 2": f"at step {FLAT64_STEPS} (epoch 2)"
              in log, "history": h["epoch"] == [1, 2, 3],
              "step": tree["step"] == 3 * FLAT64_STEPS,
              "bank count": int(tree["bank_count"])
              == 3 * cfg.depth * 3 * FLAT64_STEPS,
              "finite": all(math.isfinite(v) for k in h for v in h[k])}
        print(f"flat n=64 --resume: epochs 2-3 in {resume_s:.1f} s; val "
              f"{h['val_acc']}; checks {ok}", flush=True)
        if not all(ok.values()):
            raise AssertionError(f"route A --resume: {ok}\n{log[-2000:]}")
    torch.cuda.empty_cache()

    say("phase (r) step 3: route B, cli.bench --train on the 224 preset")
    reset_launches()
    row = bench.main(["--preset", FLAT_PRESET, "--train", "--batch-sizes",
                      str(FLAT224_BATCH), "--steps", str(TRAIN_STEPS)])[0]
    launches = launch_counts()
    steps = TRAIN_STEPS + 1
    depth = get_preset(FLAT_PRESET).model.depth
    print(f"224 train step ({FLAT_PRESET}, branch path): {row['ms_per_step']:.3f} "
          f"ms per step of {row['batch']}, {row['img_per_s']:.1f} img/s "
          f"(CUDA events, bf16, {row['steps']} steps after one warm-up), "
          f"losses {row['first_loss']:.4f} -> {row['last_loss']:.4f}, peak "
          f"memory {row['max_memory_allocated'] / 2 ** 30:.2f} GiB, bank "
          f"count {row['bank_count']}, launches {launches}; card "
          f"{card_line()}", flush=True)
    ok = (all(n == 0 for n in launches.values())
          and row["bank_count"] == 3 * depth * steps
          and all(map(math.isfinite, (row["first_loss"], row["last_loss"]))))
    if not ok:
        raise AssertionError(f"route B: {row}, launches {launches}")
    torch.cuda.empty_cache()
    print(f"phase (r): route A steps, cli.train {train_s:.1f} s, --resume "
          f"{resume_s:.1f} s; in all {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def stl_path(K, dev):
    """Phase (s): the 96 px STL stage.  One hqavit_tiny_proc_stl train
    step and one SimCLR step at full width and depth with the counts
    reset just before each (each n=16 unit's forward and backward 8 times
    a step, through the tensor-core entries), their kernels against the
    plain versions at CHECK_DEPTH, hqavit_v2_c100's eval logits kernels
    against plain, and the 32 -> 96 px transfer's pos_embed resize on the
    card against the CPU's."""
    import torch
    from pathlib import Path

    from qavit_tpu_torch.ckpt import checkpoint as C
    from qavit_tpu_torch.configs import get_preset
    from qavit_tpu_torch.nn.layers import DropoutRng, resize_pos_embed
    from qavit_tpu_torch.nn.models import build_model
    from qavit_tpu_torch.train import simclr as TS
    from qavit_tpu_torch.train.optim import make_schedule
    from qavit_tpu_torch.train.state import create_train_state
    from qavit_tpu_torch.train.steps import make_train_step

    t_phase = time.perf_counter()
    mma = {f"{u}_mma" for u in MMA_BWD} | {f"{u}_bwd_mma" for u in MMA_BWD}

    def counted(what, depth, run):
        """Run ``run`` with the counts reset just before; check one
        forward and one backward launch a block, each through its n=16
        tensor-core entry."""
        reset_launches()
        t = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t)
        launches, routes = launch_counts(), dict(K.ROUTES)
        print(f"{what}: one step in {ms:.1f} ms (host clock, first call), "
              f"launches {launches}; per C entry {routes}", flush=True)
        want = {n: 0 if n == "flash_attention" else depth for n in launches}
        want_routes = {n: depth if n in mma else 0 for n in routes}
        if launches != want or routes != want_routes:
            raise AssertionError(f"{what}: launches {launches}, routes "
                                 f"{routes}, expected {want}, {want_routes}")
        return out

    say("phase (s) step 1: the 96 px train step")
    preset = get_preset(STL_PRESET)
    cfg, tc = preset.model, preset.train
    gen = torch.Generator().manual_seed(23)
    imgs = torch.randn(STL_BATCH, cfg.img_size, cfg.img_size, 3,
                       generator=gen).to(dev)
    tgts = torch.randint(0, cfg.num_classes, (STL_BATCH,),
                         generator=gen).to(dev)
    state = create_train_state(build_model(cfg, dev, seed=0), tc.use_ema,
                               tc.ema_decay)
    step = make_train_step(cfg, tc, make_schedule(tc, 5000 // STL_BATCH))
    m = counted(f"{STL_PRESET} train step (bf16, B={STL_BATCH})", cfg.depth,
                lambda: step(state, imgs, tgts, 3))
    loss, bank = float(m["loss"]), int(state.bank_count)
    print(f"{STL_PRESET} train step: loss {loss:.4f}, bank count {bank}",
          flush=True)
    if bank != 3 * cfg.depth or not math.isfinite(loss):
        raise AssertionError(f"96 px train step: loss {loss}, bank {bank}")
    del state, step, m
    kernel_vs_plain_step(K, cfg, dev, STL_PRESET, STL_BATCH)
    torch.cuda.empty_cache()

    say("phase (s) step 2: the SimCLR step")
    sc = get_preset("simclr_stl10").model
    views = [torch.randn(SIMCLR_BATCH, sc.img_size, sc.img_size, 3,
                         generator=gen).to(dev) for _ in range(2)]
    state = create_train_state(TS.build_simclr(sc, dev, seed=0),
                               use_ema=False)
    step = TS.make_simclr_train_step(TS.simclr_schedule(0.005, 95, 285))
    m = counted(f"SimCLR step (bf16, 2 x {SIMCLR_BATCH} images)", sc.depth,
                lambda: step(state, views[0], views[1], 0))
    loss, bank = float(m["loss"]), int(state.bank_count)
    chance = math.log(2 * SIMCLR_BATCH - 1)
    print(f"SimCLR step: NT-Xent {loss:.4f} (chance ln(2B - 1) = "
          f"{chance:.4f}), grad norm {float(m['grad_norm']):.4f}, bank "
          f"count {bank}", flush=True)
    if bank != 3 * sc.depth or not math.isfinite(loss):
        raise AssertionError(f"SimCLR step: loss {loss}, bank {bank}")
    del state, step, m
    ccfg = check_depth(sc)
    images = torch.cat(views)

    def contrastive(net, mc):
        net.train()
        z, _ = net(images, train=True, rng=DropoutRng(77, dev))
        lv = TS.nt_xent_loss(z)
        return lv, torch.autograd.grad(lv, list(net.parameters()),
                                       allow_unused=True)

    grads = collect_grads(K, ccfg,
                          lambda mc: TS.build_simclr(mc, dev, seed=0),
                          contrastive)
    losses = {k: v[0] for k, v in grads.items()}
    err = max(abs(losses[d, "kernel"] - losses[d, "plain"])
              / abs(losses[d, "plain"]) for d in ("float32", "bfloat16"))
    ok = err <= BF16_LOSS_TOLERANCE
    print(f"SimCLR NT-Xent kernels vs plain at depth {ccfg.depth}: "
          f"{losses}, worst relative {err:.2e}, tolerance "
          f"{BF16_LOSS_TOLERANCE:.0e}  {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("SimCLR losses disagree")
    check_step_grads(grads, True, f"SimCLR, 2 x {SIMCLR_BATCH} images")
    del grads
    torch.cuda.empty_cache()

    say("phase (s) step 3: hqavit_v2_c100 eval logits, kernels vs plain")
    v2 = get_preset("hqavit_v2_c100").model
    x = torch.randn(V2_BATCH, v2.img_size, v2.img_size, 3,
                    generator=gen).to(dev)
    model_tol = {"bfloat16": 2.0 ** -4, "float32": 1e-4}
    for dtype_name in ("bfloat16", "float32"):
        model = build_model(v2.replace(dtype=dtype_name), dev, seed=0)
        if list(model.buffers()):
            raise AssertionError("hqavit_v2_c100 holds BatchNorm buffers")
        with torch.inference_mode():
            reset_launches()
            lk, _ = model(x)
            torch.cuda.synchronize()
            launches = launch_counts()
            with mock.patch.multiple(K, **K.PLAIN):
                lp, _ = model(x)
        err = (lk - lp).abs().max().item()
        bound = model_tol[dtype_name] * lp.abs().max().item()
        want = {n: v2.depth if n in K.UNITS else 0 for n in launches}
        ok = (bool(torch.isfinite(lk).all()) and err <= bound
              and launches == want
              and tuple(lk.shape) == (V2_BATCH, v2.num_classes))
        print(f"hqavit_v2_c100 logits kernels vs plain, {dtype_name}, "
              f"B={V2_BATCH}: max_abs_err {err:.3e} tolerance {bound:.3e}, "
              f"launches {launches}  {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"hqavit_v2_c100 {dtype_name} logits")
        del model
    torch.cuda.empty_cache()

    say("phase (s) step 4: the 32 -> 96 px transfer")
    src_cfg = get_preset("hqavit_proc100_hard").model
    src = build_model(src_cfg, dev, seed=0)
    with tempfile.TemporaryDirectory(prefix="qv_stl_") as out:
        C.save_train_state(Path(out) / "ck32", create_train_state(src,
                                                                  False),
                           src_cfg)
        dst = build_model(cfg, dev, seed=1)
        C.load_for_transfer(Path(out) / "ck32", dst, drop_head=True)
    want = resize_pos_embed(src.pos_embed.detach().cpu(), cfg.grid_size)
    got = dst.pos_embed.detach().cpu()
    err = (got - want).abs().max().item()
    bound = STL_RESIZE_TOLERANCE * want.abs().max().item()
    same = torch.equal(dst.stage1_blocks[0].quad_block.swa.qkv.kernel,
                       src.stage1_blocks[0].quad_block.swa.qkv.kernel)
    ok = (tuple(got.shape) == (1, cfg.num_patches, cfg.embed_dim)
          and err <= bound and same)
    print(f"transfer 32 -> 96 px: pos_embed {tuple(src.pos_embed.shape)} -> "
          f"{tuple(got.shape)} on the card vs the CPU resize, max_abs_err "
          f"{err:.3e} tolerance {bound:.3e}; block weights copied {same}  "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("the 32 -> 96 px transfer disagrees")
    del src, dst
    torch.cuda.empty_cache()
    print(f"phase (s): {time.perf_counter() - t_phase:.1f} s; card "
          f"{card_line()}", flush=True)


def eval_vjp_checks(K, dev, g, p, bank, batches, suffix):
    """Phase (t): at each batch in ``batches``, each unit's eval forward
    under autograd (``_eval_unit``: the inference forward's kernel, bit
    for bit) and its eval-mode backward kernel against autograd through
    the plain eval version (bf16); then each eval-mode backward's call and
    device time at every batch, against its plain version and bound.
    Returns [(backward name, kernel row)] at the largest batch (row names
    + ``suffix``; the launches are set by the caller) and the device ms at
    B=1 by unit."""
    import torch

    from qavit_tpu_torch.kernels import build
    from qavit_tpu_torch.kernels import unit_checks as UC

    dtype = torch.bfloat16
    gen = torch.Generator().manual_seed(24)
    lib = K.bind(build.load().lib)
    stream = torch.cuda.current_stream().cuda_stream
    rows, small = [], {}
    for b in batches:
        x = (torch.randn(b, g.n, g.c, generator=gen) * 2).to(dev, dtype)
        inputs = UC.unit_inputs(p, g, dtype, x, bank)
        grid = K.train_grid(dev, b)
        for unit in K.UNITS:
            batch = [t.detach() for t in inputs[unit]]
            n = K._N_DIFF_OUT[unit]
            cots = UC.random_cotangents(unit, batch, dtype, gen)
            leaves = [t.clone().requires_grad_(True) for t in batch]
            weights = [t for _, t in K.unit_params(unit, p)]
            with torch.inference_mode():
                inf = K._eval_unit(unit, p, batch, g, dtype)
            got = K._eval_unit(unit, p, leaves, g, dtype)
            got = got if isinstance(got, tuple) else (got,)
            inf = inf if isinstance(inf, tuple) else (inf,)
            same = all(torch.equal(a, c) for a, c in zip(got, inf))
            gk = torch.autograd.grad(got, leaves + weights, cots,
                                     allow_unused=True)
            ref = K.PLAIN[unit](p, *leaves, g, dtype)
            ref = ref if isinstance(ref, tuple) else (ref,)
            out_err = max(K.max_abs_err(a, c) / max(
                c.float().abs().max().item(), 1e-30)
                for a, c in zip(got[:n], ref[:n]))

            def plain_bwd():
                return torch.autograd.grad(ref[:n], leaves + weights, cots,
                                           retain_graph=True,
                                           allow_unused=True)

            gp = plain_bwd()
            pairs = [(a, c) for a, c in zip(gk, gp) if c is not None]
            grad_abs, grad_rel, grads_ok = K.compare_grads(pairs, dtype)
            ok = grads_ok and same and out_err <= K.TOLERANCE[dtype]
            print(f"check {unit} eval VJP n={g.n} B={b} {dtype}: outputs "
                  f"{out_err:.2e} (tolerance {K.TOLERANCE[dtype]:.2e}), "
                  f"equal to the inference forward {same}, gradients "
                  f"relative {grad_rel:.2e} (tolerance "
                  f"{K.GRAD_TOLERANCE[dtype]:.2e})  {'ok' if ok else 'FAIL'}",
                  flush=True)
            if not ok:
                raise AssertionError(f"{unit}: the eval-mode VJP disagrees "
                                     f"at n={g.n} B={b}")
            ws = K._FWD[unit](lib, p, *batch, g, dtype, stream,
                              keep_ws=True)[-1]

            def bwd():
                return K._BWD[unit](lib, p, *batch, g, dtype, stream, None,
                                    grid, ws, *cots)

            kern = csrc_kernel(K, unit, g, dtype, True)
            dms = device_ms(bwd, 10, kern)
            if b == 1:
                small[unit] = dms
                print(f"time {unit}_bwd eval n={g.n} B=1: kernel on the "
                      f"device {dms:.4f} ms, bound "
                      f"{1e3 * bwd_bound_ms(unit, g, 1, p):.2f} us",
                      flush=True)
                continue
            name = f"{unit}_bwd"
            rows.append((name, kernel_row(
                f"{record_name(K, unit, g, dtype, True)}_eval{suffix}",
                f"qavit_tpu_torch/csrc/{name}.cu", REPLACES[name], 0,
                grad_abs, cuda_ms(bwd, iters=10),
                cuda_ms(plain_bwd, iters=10), unit_bwd_work(unit, g, b, 2, p),
                dtype, dms)))
            del ref, leaves, gk, gp
    return rows, small


def bwd_bound_ms(unit, g, b, p):
    """The bound of a unit's bf16 backward at batch b, in ms."""
    nbytes, flops = unit_bwd_work(unit, g, b, 2, p)
    return max(1e3 * nbytes / HBM_BYTES_PER_S,
               1e3 * flops / PEAK_FLOPS["torch.bfloat16"])


def gradcam_vs_plain(K, dev, preset, n_images):
    """Phase (t): Grad-CAM of the first ``n_images`` synthetic test images
    of ``preset`` at full width (seed-0 weights) through the kernels,
    against the plain versions in bf16 and float32 on the card.  Returns
    the ms per image through the kernels (host clock, synchronised)."""
    import torch

    from qavit_tpu_torch.configs import get_preset
    from qavit_tpu_torch.data.augment import eval_batch
    from qavit_tpu_torch.data.datasets import synthetic_dataset
    from qavit_tpu_torch.data.pipelines import get_pipeline
    from qavit_tpu_torch.interpret import attention_rollout, grad_cam
    from qavit_tpu_torch.kernels import flash_attention as FA
    from qavit_tpu_torch.nn.models import build_model

    pr = get_preset(preset)
    cfg = pr.model
    ds = synthetic_dataset(pr.dataset, cfg.img_size, cfg.num_classes,
                           n_train=0, n_test=n_images, seed=0)
    images = eval_batch(torch.from_numpy(ds.test_images).to(dev),
                        get_pipeline(pr.dataset).aug)
    m16 = build_model(cfg, dev, seed=0)
    m32 = build_model(cfg.replace(dtype="float32"), dev, seed=0)

    def plain():
        return (mock.patch.multiple(K, **K.PLAIN) if cfg.hybrid
                else mock.patch.object(FA, "flash_attention", FA.plain))

    grad_cam(m16, images[0])                 # warm-up (plans, kernels)
    ms = []
    for i in range(n_images):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cam, cls = grad_cam(m16, images[i])
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        with plain():
            cam16, cls16 = grad_cam(m16, images[i])
            cam32, _ = grad_cam(m32, images[i], class_idx=cls16)
        own = float(abs(cam16 - cam32).max())
        dist = float(abs(cam - cam16).max())
        ok = (cls == cls16 and cam.shape == (cfg.img_size, cfg.img_size)
              and bool((cam >= 0).all() and (cam <= 1).all())
              and dist <= GRADCAM_FACTOR * own + 1e-6)
        print(f"check grad-cam {preset} image {i}: class {cls} (plain "
              f"{cls16}), CAM kernels vs plain bf16 {dist:.3e}, plain bf16 "
              f"vs float32 {own:.3e} (limit {GRADCAM_FACTOR:g}x), "
              f"{ms[-1]:.1f} ms  {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"{preset}: Grad-CAM through the kernels "
                                 f"disagrees with the plain one")
    if preset != TIN_PRESET:
        sal = attention_rollout(m16, images[0])
        # min-max normalised on the token grid, then upsampled: in [0, 1]
        ok = (sal.shape == (cfg.img_size, cfg.img_size)
              and bool(sal.min() >= 0 and sal.max() <= 1 + 1e-5)
              and sal.max() >= 0.5)
        print(f"check rollout {preset}: shape {sal.shape}, range "
              f"[{sal.min():.3f}, {sal.max():.3f}]  {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            raise AssertionError(f"{preset}: rollout out of range")
    del m16, m32
    return sum(ms) / len(ms)


def interpret_path(K, dev, g, p, bank, g64, p64, bank64):
    """Phase (t): the eval-mode VJP checks and times at n=16 and n=64;
    ``cli.evaluate --gradcam --rollout`` with the counts reset just before
    and read just after; Grad-CAM kernels vs plain on three presets;
    ``cli.verify_gpu``.  Returns the kernel rows."""
    import torch
    from pathlib import Path

    from qavit_tpu_torch.cli import evaluate, verify_gpu
    from qavit_tpu_torch.configs import get_preset

    t_phase = time.perf_counter()
    say("phase (t) step 1: the eval-mode VJP of each unit")
    rows16, small16 = eval_vjp_checks(K, dev, g, p, bank,
                                      EVAL_VJP_BATCHES[16], "")
    rows64, small64 = eval_vjp_checks(K, dev, g64, p64, bank64,
                                      EVAL_VJP_BATCHES[64], "@n64")

    say("phase (t) step 2: cli.evaluate --gradcam --rollout")
    n_img = GRADCAM_IMAGES["hqavit_c100"]
    with tempfile.TemporaryDirectory(prefix="qv_interp_") as out:
        reset_launches()
        r = evaluate.main(["--preset", "hqavit_c100", "--synthetic",
                           "--batch-size", str(INTERP_EVAL_BATCH),
                           "--batches", "1",
                           "--gradcam", "--gradcam-images", str(n_img),
                           "--rollout", "--rollout-images", str(n_img),
                           "--out-dir", out])
        launches, routes = launch_counts(), dict(K.ROUTES)
        pngs = sorted(q.relative_to(out).as_posix()
                      for q in Path(out).rglob("*.png"))
    depth = get_preset("hqavit_c100").model.depth
    forwards = 3 + 2 * n_img     # smoke, untimed, 1 batch, Grad-CAM, rollout
    want = {n: depth * (forwards if n in K.UNITS else n_img)
            if n.startswith("unit_") else 0 for n in launches}
    want_routes = {n: depth * n_img if n.endswith("_bwd_mma") else
                   depth * forwards if n.endswith("_mma") else 0
                   for n in routes}
    cams = [q for q in pngs if q.startswith("gradcam/gradcam_")]
    rolls = [q for q in pngs if q.startswith("rollout_")]
    print(f"cli.evaluate --gradcam --rollout: {r['count']} images, "
          f"{len(cams)} Grad-CAM and {len(rolls)} rollout PNGs, e.g. "
          f"{cams[:1]} {rolls[:1]}; launches {launches}; per C entry "
          f"{ {k: v for k, v in routes.items() if v} }", flush=True)
    if launches != want or routes != want_routes or len(cams) != 2 * n_img \
            or len(rolls) != 2 * n_img:
        raise AssertionError(f"cli.evaluate --gradcam --rollout: launches "
                             f"{launches}, routes {routes}, PNGs {pngs}; "
                             f"expected {want}, {want_routes}")
    for name, row in rows16:
        row["launches"] = launches[name]

    say("phase (t) step 3: Grad-CAM kernels vs plain, rollout")
    per_image = {}
    for pr, k in GRADCAM_IMAGES.items():
        reset_launches()
        per_image[pr] = gradcam_vs_plain(K, dev, pr, k)
        if pr == TIN_PRESET:      # n=64: the launches of one Grad-CAM image
            tin = launch_counts()  # (k images and the warm-up one)
            for name, row in rows64:
                row["launches"] = tin[name] // (k + 1)
    print("grad-cam ms per image (kernels, host clock): " + ", ".join(
        f"{k} {v:.1f}" for k, v in per_image.items()) + "; eval-mode "
        "backward device ms at B=1: n=16 " + ", ".join(
            f"{u} {v:.4f}" for u, v in small16.items()) + "; n=64 "
        + ", ".join(f"{u} {v:.4f}" for u, v in small64.items()), flush=True)

    say(f"phase (t) step 4: cli.verify_gpu --batch-sizes {VERIFY_BATCHES}")
    if not verify_gpu.main(["--batch-sizes", VERIFY_BATCHES]):
        raise AssertionError("cli.verify_gpu: VERDICT FAIL")
    torch.cuda.empty_cache()
    print(f"phase (t): {time.perf_counter() - t_phase:.1f} s; card "
          f"{card_line()}", flush=True)
    return [row for _, row in rows16 + rows64]


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
    for line in ptxas_summary(kl.log):
        print("ptxas:", line, flush=True)
    from qavit_tpu_torch.kernels import mma_selftest as MS

    rows, ok = MS.check(kl.lib, seed=0, device=torch.device("cuda"),
                        stream=torch.cuda.current_stream().cuda_stream)
    for trans, err, bound in rows:
        print(f"check mma self-test (ldmatrix{'.trans' if trans else ''} -> "
              f"mma.sync m16n8k16 vs A @ B): max_abs_err {err:.3e} bound "
              f"{bound:.3e}  {'ok' if err <= bound else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("the tensor-core primitives disagree with A @ B")
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
        mma16_checks(K, g, p, bank, dev, gen, CHECK_BATCH)
    d16 = K._dims(g, CHECK_BATCH, p, 1, 1, None)
    d16t = K._dims(g, CHECK_BATCH, p, 1, 1, K.R.block_rng(0, 0.1, 0.1))
    for kern, smem in (
            ("swa_mma_kernel", kl.lib.qv_unit_swa_mma_smem(None)),
            ("msda_mma16_kernel",
             kl.lib.qv_unit_msda_mma_smem(ctypes.byref(d16))),
            ("cga_mma_kernel",
             f"{kl.lib.qv_unit_cga_mma_smem(ctypes.byref(d16))} (eval), "
             f"{kl.lib.qv_unit_cga_mma_smem(ctypes.byref(d16t))} (train)"),
            ("cross_tail_mma_kernel",
             kl.lib.qv_unit_cross_tail_mma_smem(None))):
        print_ptxas(kern)
        print(f"{kern}: {smem} B of dynamic shared memory per block",
              flush=True)
    say("phase (c) kernel checks: done")

    say("phase (d) main path: start")
    reset_launches()
    r = evaluate.main(["--preset", "hqavit_c100", "--synthetic", "--seed",
                       "0", "--batch-size", str(BATCH), "--batches",
                       str(MAIN_BATCHES)])
    launches = launch_counts()
    routes = dict(K.ROUTES)
    forwards = MAIN_BATCHES + 2       # + the smoke and the untimed batch
    print(f"main path: {r['count']} images, top-1 {r['top1']:.2f}%, top-5 "
          f"{r['top5']:.2f}%, loss {r['loss']:.4f}, {r['img_per_s']:.1f} "
          f"img/s (host clock, {forwards} forwards)", flush=True)
    print(f"launches during the main path: {launches}", flush=True)
    for name, n in launches.items():
        want = cfg.depth * forwards if name in K.UNITS else 0
        if n != want:
            raise AssertionError(f"{name}: {n} launches, expected {want} "
                                 f"({cfg.depth} per forward x {forwards} "
                                 f"for each forward unit)")
    print(f"launches per C entry: {routes}", flush=True)
    for unit in K.UNITS:
        if (routes[f"{unit}_mma"], routes[unit]) != (cfg.depth * forwards,
                                                     0):
            raise AssertionError(
                f"{unit}: {routes[f'{unit}_mma']} launches of the "
                f"tensor-core entry and {routes[unit]} of the CUDA-core "
                f"one, expected {cfg.depth * forwards} and 0")
    if not (r["count"] == BATCH * MAIN_BATCHES and r["loss"] == r["loss"]
            and 0.0 <= r["top1"] <= r["top5"] <= 100.0):
        raise AssertionError(f"main path result out of range: {r}")

    from qavit_tpu_torch.data.augment import eval_batch
    from qavit_tpu_torch.data.datasets import synthetic_dataset
    from qavit_tpu_torch.data.pipelines import get_pipeline

    ds = synthetic_dataset("cifar100_hqa", cfg.img_size, cfg.num_classes,
                           n_test=BATCH, seed=0)
    images = eval_batch(torch.from_numpy(ds.test_images).to(dev),
                        get_pipeline("cifar100_hqa").aug)
    model_tol = {"bfloat16": 2.0 ** -4, "float32": 1e-4}
    for dtype_name in ("bfloat16", "float32"):
        model = build_model(cfg.replace(dtype=dtype_name), dev, seed=0)
        with torch.inference_mode():
            lk, _ = model(images)
            with mock.patch.multiple(K, **K.PLAIN):
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
        mma16_checks(K, g, p, bank, dev, gen, BATCH)
        x = torch.randn(BATCH, g.n, g.c, generator=gen).to(dev, dtype)
        for name, (kern, plain_fn) in unit_calls(K, p, g, dtype, x,
                                                 bank).items():
            err, _, _, ok = worst_error(K, kern(), plain_fn())
            if not ok:
                raise AssertionError(f"{name} disagrees at B={BATCH}")
            record.append(kernel_row(
                record_name(K, name, g, dtype),
                f"qavit_tpu_torch/csrc/{name}.cu", REPLACES[name],
                launches[name], err, cuda_ms(kern), cuda_ms(plain_fn),
                unit_work(name, g, BATCH, 2, p), dtype,
                device_ms(kern, 10, csrc_kernel(K, name, g, dtype))))
    say("phase (e) timing: done")

    say("phase (f) training kernels: start")
    backward_checks(K, cfg, g, p, dev)
    say("phase (f) training kernels: done")

    say("phase (g) train path: start")
    train_launches, bench_row = train_path(K, cfg)
    say("phase (g) train path: done")

    say("phase (h) train units at B=1024, timing: start")
    record += train_unit_checks_and_timing(K, cfg, g, p, dev, train_launches)
    print(f"train step: {bench_row['ms_per_step']:.3f} ms per step of "
          f"{BATCH}, {bench_row['img_per_s']:.1f} img/s (CUDA events, "
          f"bf16, {bench_row['steps']} steps after one warm-up), peak "
          f"memory {bench_row['max_memory_allocated'] / 2 ** 30:.2f} GiB; "
          f"card {card_line()}", flush=True)
    say("phase (h) train units at B=1024, timing: done")

    say("phase (i) flash kernel checks: start")
    flash_rows = flash_checks(dev)
    say("phase (i) flash kernel checks: done")

    say("phase (j) 224 eval path: start")
    record.append(flat_path(dev, flash_rows))
    say("phase (j) 224 eval path: done")

    say("phase (k) multi-window unit checks: start")
    g64, p64, bank64 = multiwindow_checks(K, dev)
    say("phase (k) multi-window unit checks: done")

    say("phase (l) multi-window path: start")
    record += multiwindow_path(K, dev, g64, p64, bank64)
    say("phase (l) multi-window path: done")

    say("phase (m) n=64 training kernels: start")
    fwd_times = n64_train_checks(K, dev, g64, p64)
    say("phase (m) n=64 training kernels: done")

    say("phase (n) n=64 train path: start")
    record += n64_train_path(K, dev, g64, p64, fwd_times)
    say("phase (n) n=64 train path: done")

    # phase (o) generates proc100_hard once; phases (p) and (q) train on it
    with tempfile.TemporaryDirectory(prefix="qv_data_") as root:
        say("phase (o) data path: start")
        data_path(K, dev, root)
        say("phase (o) data path: done")

        say("phase (p) train loop: start")
        best = train_loop_path(K, dev, root)
        say("phase (p) train loop: done")

        say("phase (q) finetune stage: start")
        finetune_path(K, dev, root, best)
        say("phase (q) finetune stage: done")

        say("phase (r) flat QAViT train step: start")
        flat_train_path(K, dev, root)
        say("phase (r) flat QAViT train step: done")

    say("phase (s) 96 px STL stage: start")
    stl_path(K, dev)
    say("phase (s) 96 px STL stage: done")

    say("phase (t) Grad-CAM and rollout: start")
    record += interpret_path(K, dev, g, p, bank, g64, p64, bank64)
    say("phase (t) Grad-CAM and rollout: done")

    print(card_line(), flush=True)
    print(json.dumps({"kernels": record}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
