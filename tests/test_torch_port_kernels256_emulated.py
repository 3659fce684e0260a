"""The n=256 kernels' own source (qavit_tpu_torch/csrc: unit_swa256.cu,
unit_msda256.cu, unit_cga256.cu, unit_cross_tail256.cu and their pieces
in n256_ops.cuh; the SWA backward swa_bwd_mma_kernel<16> in
unit_swa_bwd.cu), compiled for the host with g++ against
tests/cuda_emulation/qv_emulate.h (``tests/torch_port_emulation.py``)
and driven through the same ctypes launch functions the card uses.

At qavit_v2_extreme_tin's geometry (C=192, 256 tokens on a 16x16 grid in
16 SWA windows of 16, 128 pooled MSDA rows), each unit's bf16 eval
forward with its eval-mode backward, and its train-mode forward (masks
on, the bank-write partials) with its backward, against the plain
version and autograd through it (``unit_checks.check_unit``: outputs
within 2^-6 of max|plain|, partials 1e-4, gradients 2^-4), at B=1
through the n=256 entries (``qv_unit_*_mma256``, ``*_mma_train256``,
``*_bwd_mma256``); the same with the NaN guard tripped; at B=2 on two
slices (two blocks of the bank pass, whose gate softmax spans a sample's
four tiles of the SWA forward; the SWA backward's cluster walking 32
windows) for the bank-writing units; and every n=256 entry refusing
float32 (ERR_ARGS)."""

import ctypes
import functools

import pytest
import torch

from qavit_tpu_torch.configs import get_preset
from qavit_tpu_torch.kernels import fused_kernels as K
from qavit_tpu_torch.kernels import unit_checks as C
from qavit_tpu_torch.kernels.fused_params import QuadBlockParams
from qavit_tpu_torch.kernels.fused_ref import make_geom
from qavit_tpu_torch.nn.bank import GlobalBankParams
from qavit_tpu_torch.nn.layers import init_weights, param_tree
from torch_port_common import one_thread  # noqa: F401 (autouse)
from torch_port_emulation import _check, emulation_library
from torch_port_emulation import two_cores  # noqa: F401 (autouse)

BF16 = torch.bfloat16


@pytest.fixture(scope="module")
def emu_lib(tmp_path_factory):
    return emulation_library(tmp_path_factory)


@functools.lru_cache(maxsize=None)
def _case(batch):
    """Seed-made block weights at qavit_v2_extreme_tin's geometry
    (perturbed off their constant inits), bank rows, write projections
    and x [batch, 256, 192]."""
    cfg = get_preset("qavit_v2_extreme_tin").model.replace(
        attn_impl="fused_block")
    g = make_geom(cfg)
    gen = torch.Generator().manual_seed(0)
    blk = init_weights(QuadBlockParams(cfg, g), gen)
    with torch.no_grad():
        for name, t in blk.named_parameters():
            if name.endswith(("scale", "fusion_weights", "gamma")):
                t.add_(0.3 * torch.randn(t.shape, generator=gen))
            elif name.endswith("bias"):
                t.add_(0.1 * torch.randn(t.shape, generator=gen))
            else:
                t.mul_(3.0)
    bank = init_weights(GlobalBankParams(cfg.bank, g.c), gen)
    bankp = {k: v.detach() for k, v in bank.write_params().items()}
    rows = [torch.randn(1, g.bank_s, g.c, generator=gen) * 0.5
            for _ in range(2)]
    x = torch.randn(batch, g.n, g.c, generator=gen) * 2
    return g, param_tree(blk), bankp, rows, x


def _routed(unit, mode):
    fwd = f"{unit}_mma256" if mode == "eval" else f"{unit}_mma_train256"
    assert K.ROUTES[fwd] == 1, K.ROUTES
    assert K.ROUTES[f"{unit}_bwd_mma256"] == 1, K.ROUTES
    assert sum(K.ROUTES.values()) == 2, K.ROUTES


def _eval_check(emu_lib, case, unit, nan_at=None):
    g, p, _, rows, x = case
    batch = list(C.unit_inputs(p, g, BF16, x.to(BF16), rows)[unit])
    if nan_at is not None:
        lead = 1 if unit == "unit_cross_tail" else 0
        batch[lead] = batch[lead].clone()
        batch[lead][nan_at] = float("nan")
    cots = C.random_cotangents(unit, batch, BF16,
                               torch.Generator().manual_seed(5))
    return C.check_unit(emu_lib, unit, p, None, batch, g, BF16,
                        K.Grid(1, 1), cots,
                        guard_tripped=nan_at is not None)


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("unit", list(K.UNITS))
def test_n256_unit_kernels(emu_lib, unit, mode):
    """The n=256 forward (eval, or train with masks and the bank
    partials) and its backward against the plain version, B=1."""
    K.reset_launches()
    if mode == "eval":
        r = _eval_check(emu_lib, _case(1), unit)
    else:
        r = _check(emu_lib, _case(1), unit, BF16, grid=K.Grid(1, 1))
    _routed(unit, mode)
    assert r.ok, r


@pytest.mark.parametrize("unit", list(K.UNITS))
def test_n256_nan_guard(emu_lib, unit):
    """A NaN in the input trips the batch-wide guard: the attention
    output is zero (train mode: proj(0) through the dropout), no gradient
    passes through the attention (its weight products add nothing though
    their inputs hold the NaN), the flag is set."""
    K.reset_launches()
    r = _check(emu_lib, _case(1), unit, BF16, grid=K.Grid(1, 1),
               nan_at=(0, 3, 5))
    _routed(unit, "train")
    assert r.ok and r.flag == 1, r


@pytest.mark.parametrize("unit", ["unit_swa", "unit_msda", "unit_cga"])
def test_n256_two_slices(emu_lib, unit):
    """B=2 in training on two slices: the bank pass's two blocks each a
    sample's 256 gates, the weight gradients' two slices summed by the
    reduction pass."""
    K.reset_launches()
    r = _check(emu_lib, _case(2), unit, BF16, grid=K.Grid(2, 2))
    _routed(unit, "train")
    assert r.ok, r


@pytest.mark.parametrize("entry", K._MMA_FWD256 + K._MMA_BWD256)
def test_n256_entries_refuse_float32(emu_lib, entry):
    """Each n=256 C entry returns ERR_ARGS for float32 before any launch
    (the wrapper raises first, naming queue 2 item 2d)."""
    args = K._ENTRY[entry[:entry.index("_mma")]]()
    fn = getattr(emu_lib, f"qv_{entry}")
    ptrs = (None,) * (3 if entry in K._MMA_FWD256 else 2)
    assert fn(ctypes.byref(args), *ptrs, 0, None) == 1
