"""Device time of ``cga_mma_kernel``'s three instances at B=1024 in bf16:
n=16 eval and train (``hqavit_c100``), n=64 eval (``hqavit_proc_tin``),
each against its plain version, by ``torch.profiler`` (the kernel alone,
``chip_smoke.device_ms``), with its ptxas lines.  To compare two designs
of the kernel, run it from the root of each tree in turns, in one call
on the card:

    python -m qavit_tpu_torch.kernels.time_cga TAG

Every line it prints starts with TAG.  Needs CUDA (it raises without).
"""

from __future__ import annotations

import sys


def main(argv=None) -> None:
    import torch

    import chip_smoke as CS
    from qavit_tpu_torch.configs import get_preset
    from qavit_tpu_torch.device import resolve_device
    from qavit_tpu_torch.kernels import build
    from qavit_tpu_torch.kernels import fused_kernels as K
    from qavit_tpu_torch.kernels import fused_ref as R
    from qavit_tpu_torch.kernels.fused_ref import make_geom
    from qavit_tpu_torch.nn.layers import param_tree

    tag = (argv if argv is not None else sys.argv[1:] or ["cga"])[0]
    dev = resolve_device("cuda")
    kl = build.load()
    lib = K.bind(kl.lib)
    for line in CS.ptxas_summary(kl.log):
        if line.startswith("cga_mma"):
            print(tag, "ptxas:", line, flush=True)
    dt = torch.bfloat16
    stream = torch.cuda.current_stream().cuda_stream
    for preset in ("hqavit_c100", "hqavit_proc_tin"):
        cfg = get_preset(preset).model
        g = make_geom(cfg)
        gen = torch.Generator().manual_seed(0)
        p = param_tree(CS.perturbed_block(cfg, g, gen).to(dev))
        bank = tuple((torch.randn(1, g.bank_s, g.c, generator=gen) * 0.5).to(
            dev) for _ in range(2))
        x = torch.randn(1024, g.n, g.c, generator=gen).to(dev, dt)
        with torch.inference_mode():
            xn = K.swa_plain(p, x, *bank, g, dt)[1]
            ref = K.cga_plain(p, xn, *bank, g, dt)
            ok = K.within_tolerance(K.unit_cga(p, xn, *bank, g, dt), ref)
            ms = CS.device_ms(lambda: K.unit_cga(p, xn, *bank, g, dt), 20,
                              "cga_mma_kernel")
        print(f"{tag} n={g.n} eval B=1024: device {ms:.4f} ms, agrees {ok}",
              flush=True)
        if g.n == 16:
            train = K.UnitTrain(R.block_rng(8, 0.1, 0.1),
                                CS.bank_write_params(cfg, g, gen, dev))
            grid = K.train_grid(dev, 1024)
            ms = CS.device_ms(lambda: K.launch_cga(lib, p, xn, *bank, g, dt,
                                                   stream, train, grid), 20,
                              "cga_mma_kernel")
            print(f"{tag} n=16 train B=1024: device {ms:.4f} ms", flush=True)


if __name__ == "__main__":
    main()
