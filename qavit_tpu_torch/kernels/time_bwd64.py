"""Device time of the four units' kernels (SWA, MSDA, CGA, cross/tail) in
bf16 with masks on.  Backwards: their n=64 instances (``hqavit_proc_tin``)
at B=128 and B=1024 and their n=16 instances (``hqavit_c100``) at B=1024.
Forwards: the n=64 train-mode ones at B=128 and B=1024, and the n=64 eval
and n=16 (eval and train) instances at B=1024.  Each is the kernel alone
by ``torch.profiler`` (``chip_smoke.device_ms``, by kernel name) beside
the wrapper's call by CUDA events; a forward also gives the device time of
all the csrc kernels its call launches (its reduction passes included).
Then the kernels' ptxas lines.  To compare two designs, run it from the
root of each tree in turns, in one call on the card:

    python -m qavit_tpu_torch.kernels.time_bwd64 TAG [--stamps]
    python -m qavit_tpu_torch.kernels.time_bwd64 TAG --forwards PRESET

With ``--stamps`` it also builds the kernels with ``-DQV_STAMPS`` into a
build directory of its own and prints the phase breakdown of the n=64
backwards and of the four n=64 train-mode forwards at both
batches: block 0's time in each phase of one launch (``QV_STAMP`` in
``csrc/common.cuh``); and the SWA and MSDA backwards' phases with the work
a CTA has at B=128 (two passes of two windows; one sample) on 16 SMs only
(B=16 on 8 clusters), against the whole card at B=128: what sharing the
card's L2 and memory costs each phase.  Every line it prints starts with
TAG.  ``--forwards PRESET`` times only that preset's forward cases, in a
process that has run nothing else (so that two trees' unchanged kernels
meet the same allocations).  Needs CUDA (it raises without).
"""

from __future__ import annotations

import ctypes
import sys

UNITS = ("unit_swa", "unit_msda", "unit_cga", "unit_cross_tail")
CASES = (("hqavit_proc_tin", 128), ("hqavit_proc_tin", 1024),
         ("hqavit_c100", 1024))
# forwards: (preset, batch, train mode)
FWD_CASES = (("hqavit_proc_tin", 128, True), ("hqavit_proc_tin", 1024, True),
             ("hqavit_proc_tin", 1024, False), ("hqavit_c100", 1024, True),
             ("hqavit_c100", 1024, False))
# the forwards whose n=64 train-mode phases --stamps prints, by the name of
# their stamps array
FWD_STAMPS = {"unit_swa": "swa_fwd", "unit_msda": "msda_fwd",
              "unit_cga": "cga_fwd", "unit_cross_tail": "cross_tail_fwd"}


def setup(preset, b, dev):
    """Seed-made block weights, bank rows, masks and, per unit, its inputs
    and cotangents at batch ``b``."""
    import torch

    import chip_smoke as CS
    from qavit_tpu_torch.configs import get_preset
    from qavit_tpu_torch.kernels import fused_kernels as K
    from qavit_tpu_torch.kernels import fused_ref as R
    from qavit_tpu_torch.kernels import unit_checks as UC
    from qavit_tpu_torch.kernels.fused_ref import make_geom
    from qavit_tpu_torch.nn.layers import param_tree

    cfg = get_preset(preset).model
    g = make_geom(cfg)
    gen = torch.Generator().manual_seed(0)
    p = param_tree(CS.perturbed_block(cfg, g, gen).to(dev))
    bankp = CS.bank_write_params(cfg, g, gen, dev)
    rows = tuple((torch.randn(1, g.bank_s, g.c, generator=gen) * 0.5).to(dev)
                 for _ in range(2))
    train = K.UnitTrain(R.block_rng(8, cfg.dropout, cfg.drop_path), bankp)
    dt = torch.bfloat16
    x = torch.randn(b, g.n, g.c, generator=gen).to(dev, dt)
    inputs = UC.unit_inputs(p, g, dt, x, rows)
    cots = {u: UC.random_cotangents(u, inputs[u], dt, gen) for u in UNITS}
    return g, p, train, inputs, cots


def backward(lib, unit, g, p, train, batch, cots, dev):
    """A function that launches the unit's backward kernel (after one
    forward for its guard flag)."""
    import torch

    from qavit_tpu_torch.kernels import fused_kernels as K

    dt = torch.bfloat16
    stream = torch.cuda.current_stream().cuda_stream
    grid = K.train_grid(dev, batch[0].shape[0])
    *_, ws = K._FWD[unit](lib, p, *batch, g, dt, stream, train, grid)
    return lambda: K._BWD[unit](lib, p, *batch, g, dt, stream, train, grid,
                                ws, *cots)


def forward(lib, unit, g, p, train, batch, dev, training=True):
    """A function that launches the unit's forward kernel, in train mode
    (with the train grid) or in eval."""
    import torch

    from qavit_tpu_torch.kernels import fused_kernels as K

    stream = torch.cuda.current_stream().cuda_stream
    grid = K.train_grid(dev, batch[0].shape[0]) if training else None
    return lambda: K._FWD[unit](lib, p, *batch, g, torch.bfloat16, stream,
                                train if training else None, grid)


def csrc_device_ms(fn, iters: int = 20):
    """{csrc kernel name: device ms per call} of the kernels ``fn``
    launches (``torch.profiler``, after a warm-up), without PyTorch's own
    (the wrapper's casts and memsets)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as CS

    fn()
    torch.cuda.synchronize()
    for _ in range(3):       # a trace that caught no kernel is taken again
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        got = {name: ms / iters for name, ms, _ in CS.device_kernels(prof)
               if name.startswith(("void qv::", "qv::"))}
        if got:
            return got
    raise RuntimeError("the profiler saw no csrc kernel in three traces")


def _time_forwards(tag, lib, dev, cases=FWD_CASES) -> None:
    """The forwards' device times: the longest csrc kernel a call
    launches (the unit's), and all of them (its reduction passes)."""
    import torch

    import chip_smoke as CS

    for preset, b, training in cases:
        g, p, train, inputs, _ = setup(preset, b, dev)
        mode = "train" if training else "eval"
        for unit in UNITS:
            fwd = forward(lib, unit, g, p, train, inputs[unit], dev, training)
            kerns = csrc_device_ms(fwd)
            main = max(kerns, key=kerns.get)
            call = CS.cuda_ms(fwd, iters=10)
            short = main.split("(")[0].replace("void ", "")
            print(f"{tag} fwd {unit} n={g.n} {mode} B={b}: device "
                  f"{kerns[main]:.4f} ms ({short}), all csrc kernels "
                  f"{sum(kerns.values()):.4f} ms in {len(kerns)}, call "
                  f"{call:.4f} ms", flush=True)
        del inputs
        torch.cuda.empty_cache()


def _fwd_stamps(tag, kl, dev) -> None:
    """The n=64 train-mode forwards' phases in one launch
    (:data:`FWD_STAMPS`), from the stamps build."""
    import torch

    from qavit_tpu_torch.kernels import fused_kernels as K

    lib = K.bind(kl.lib)
    out = (ctypes.c_ulonglong * 16)()
    names = ctypes.c_char_p()
    for preset, b, _ in FWD_CASES[:2]:
        g, p, train, inputs, _ = setup(preset, b, dev)
        for unit, arr in FWD_STAMPS.items():
            read = getattr(kl.lib, f"qv_stamps_{arr}")
            read.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            fwd = forward(lib, unit, g, p, train, inputs[unit], dev)
            fwd()
            torch.cuda.synchronize()
            read(out, ctypes.byref(names))
            fwd()
            torch.cuda.synchronize()
            if read(out, ctypes.byref(names)) != 0:
                raise RuntimeError(f"{unit}: reading the stamps failed")
            labels = names.value.decode().split(",")
            total = sum(out[:len(labels)]) / 1e6
            parts = ", ".join(f"{name} {out[k] / 1e6:.4f}"
                              for k, name in enumerate(labels))
            print(f"{tag} stamps {unit}_fwd n={g.n} train B={b}: block 0 "
                  f"{total:.4f} ms: {parts}", flush=True)
        del inputs
        torch.cuda.empty_cache()


def _stamps(tag, kl, dev, cases=CASES[:2], units=UNITS, note="") -> None:
    """The n=64 kernels' phases in one launch, from the stamps build."""
    import torch

    from qavit_tpu_torch.kernels import fused_kernels as K

    lib = K.bind(kl.lib)
    out = (ctypes.c_ulonglong * 16)()
    names = ctypes.c_char_p()
    for preset, b in cases:
        g, p, train, inputs, cots = setup(preset, b, dev)
        for unit in units:
            read = getattr(kl.lib, f"qv_stamps_{unit[5:]}_bwd")
            read.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            bwd = backward(lib, unit, g, p, train, inputs[unit], cots[unit],
                           dev)
            bwd()
            torch.cuda.synchronize()
            read(out, ctypes.byref(names))
            bwd()
            torch.cuda.synchronize()
            if read(out, ctypes.byref(names)) != 0:
                raise RuntimeError(f"{unit}: reading the stamps failed")
            labels = names.value.decode().split(",")
            total = sum(out[:len(labels)]) / 1e6
            parts = ", ".join(f"{name} {out[k] / 1e6:.4f}"
                              for k, name in enumerate(labels))
            print(f"{tag} stamps {unit}_bwd n={g.n} B={b}{note}: block 0 "
                  f"{total:.4f} ms: {parts}", flush=True)


def main(argv=None) -> None:
    import torch

    import chip_smoke as CS
    from qavit_tpu_torch.device import resolve_device
    from qavit_tpu_torch.kernels import build
    from qavit_tpu_torch.kernels import fused_kernels as K

    args = list(argv if argv is not None else sys.argv[1:])
    stamps = "--stamps" in args
    only = None
    if "--forwards" in args:
        i = args.index("--forwards")
        only = args[i + 1]
        del args[i:i + 2]
    args = [a for a in args if a != "--stamps"]
    tag = (args or ["bwd64"])[0]
    dev = resolve_device("cuda")
    kl = build.load()
    lib = K.bind(kl.lib)
    print(f"{tag} card: {CS.card_line()}", flush=True)
    if only is not None:
        _time_forwards(tag, lib, dev, [c for c in FWD_CASES if c[0] == only])
        return
    for preset, b in CASES:
        g, p, train, inputs, cots = setup(preset, b, dev)
        for unit in UNITS:
            kern = CS.csrc_kernel(K, unit, g, torch.bfloat16, True)
            bwd = backward(lib, unit, g, p, train, inputs[unit], cots[unit],
                           dev)
            ms = CS.device_ms(bwd, 20, kern)
            call = CS.cuda_ms(bwd, iters=10)
            print(f"{tag} {kern} ({unit}_bwd) n={g.n} B={b}: device "
                  f"{ms:.4f} ms, call {call:.4f} ms", flush=True)
        del inputs, cots
        torch.cuda.empty_cache()
    _time_forwards(tag, lib, dev)
    for line in CS.ptxas_summary(kl.log):
        if line.startswith(("swa_", "msda_", "cga_", "cross_tail_")):
            print(tag, "ptxas:", line, flush=True)
    if stamps:
        skl = build.load(build.BUILD_DIR / "stamps", ("-DQV_STAMPS",))
        _fwd_stamps(tag, skl, dev)
        _stamps(tag, skl, dev)
        # the work a CTA has at B=128 on 8 clusters (16 SMs)
        cluster_grid = K.cluster_grid
        K.cluster_grid = lambda entry, grid, b, device=None: (
            K.Grid(8, grid.reduce) if entry in K.CLUSTER_BWD else grid)
        try:
            _stamps(tag, skl, dev, (("hqavit_proc_tin", 16),),
                    ("unit_swa", "unit_msda"), " on 8 clusters")
        finally:
            K.cluster_grid = cluster_grid


if __name__ == "__main__":
    main()
