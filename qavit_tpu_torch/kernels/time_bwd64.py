"""Device time of the four units' backward kernels (SWA, MSDA, CGA,
cross/tail) in bf16 with masks on: their n=64 instances
(``hqavit_proc_tin``) at B=128 and B=1024 and their n=16 instances
(``hqavit_c100``) at B=1024, each the kernel alone by ``torch.profiler`` (``chip_smoke.device_ms``, by kernel name),
beside the wrapper's call by CUDA events; then their ptxas lines.  To
compare two designs, run it from the root of each tree in turns, in one
call on the card:

    python -m qavit_tpu_torch.kernels.time_bwd64 TAG [--stamps]

With ``--stamps`` it also builds the kernels with ``-DQV_STAMPS`` into a
build directory of its own and prints the n=64 kernels' phase breakdown
at both batches: block 0's time in each phase of one launch
(``QV_STAMP`` in ``csrc/common.cuh``); and the SWA and MSDA backwards'
phases with the work a CTA has at B=128 (two passes of two windows; one
sample) on 16 SMs only (B=16 on 8 clusters), against the whole card at
B=128: what sharing the card's L2 and memory costs each phase.  Every
line it prints starts with TAG.  Needs CUDA (it raises without).
"""

from __future__ import annotations

import ctypes
import sys

UNITS = ("unit_swa", "unit_msda", "unit_cga", "unit_cross_tail")
CASES = (("hqavit_proc_tin", 128), ("hqavit_proc_tin", 1024),
         ("hqavit_c100", 1024))


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
    args = [a for a in args if a != "--stamps"]
    tag = (args or ["bwd64"])[0]
    dev = resolve_device("cuda")
    kl = build.load()
    lib = K.bind(kl.lib)
    print(f"{tag} card: {CS.card_line()}", flush=True)
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
    for line in CS.ptxas_summary(kl.log):
        if line.startswith(("swa_bwd", "msda_bwd", "cga_bwd",
                            "cross_tail_bwd")):
            print(tag, "ptxas:", line, flush=True)
    if stamps:
        skl = build.load(build.BUILD_DIR / "stamps", ("-DQV_STAMPS",))
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
