"""The training kernels' own source (qavit_tpu_torch/csrc: the train-mode
forward units and the four backward kernels unit_*_bwd.cu), compiled for
the host with g++ against tests/cuda_emulation/qv_emulate.h and driven
through the same ctypes launch functions the card uses.  Each unit's
forward outputs and bank-write partials are held against its plain
version, and its backward kernel's gradients against autograd through
the plain version, with the same hash masks (dropout 0.1, drop-path 0.1)
and cotangents, at the tiny width and the hqavit_c100 width, in float32
and bf16, over 2 blocks: 3 samples at the tiny width, 6 at hqavit_c100's,
so that the per-block partial sums and their reduction are exercised
there too, where the bf16 forwards run on the tensor cores over tiles of
four samples (two tiles, the second short, a block each), and the bf16
tensor-core backward kernels, which take two samples a pass (the CGA
backward four), run a short pass.  Those four also run in bf16 at that
width with the NaN guard tripped and with 12 bank rows (the SWA and CGA
backwards with their gradient workspace left as allocated, since they
store every field), their routes (fused_kernels.bwd_entry, swa_route,
msda_route, cga_route, cross_tail_route) are checked, their backward C
entries return ERR_ARGS for a geometry they do not take, and the SWA,
MSDA and CGA tensor-core forwards replay the plain version's masks.
Tolerances: fused_kernels.TOLERANCE
(outputs), unit_checks.PARTIAL_TOLERANCE (partials) and
fused_kernels.GRAD_TOLERANCE (gradients), each stated with its reason
where it is defined.

The n=64 training kernels (hqavit_tiny_in's geometry, on two-CTA
clusters) are ``tests/test_torch_port_train_kernels64_emulated.py``; the
library build and the shared cases are ``tests/torch_port_emulation.py``."""

import ctypes

import pytest
import torch

from qavit_tpu_torch.kernels import fused_kernels as K
from qavit_tpu_torch.kernels import fused_ref as R
from qavit_tpu_torch.kernels.fused_ref import make_geom
from torch_port_common import one_thread  # noqa: F401 (autouse)
from torch_port_emulation import (B, GRID, MMA_BWD, UNITS, _case, _cfg,
                                  _check, emulation_library)
from torch_port_emulation import two_cores  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def emu_lib(tmp_path_factory):
    return emulation_library(tmp_path_factory)


@pytest.fixture(scope="module", params=["tiny", "flagship_width"])
def case(request):
    return _case(request.param)


@pytest.fixture(scope="module")
def tiny_case():
    return _case("tiny")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("unit", UNITS)
def test_train_forward_and_backward_kernels(emu_lib, case, unit, dtype):
    r = _check(emu_lib, case, unit, dtype)
    assert r.ok, r


@pytest.mark.parametrize("unit", UNITS)
def test_nan_guard_passes_zero_gradient(emu_lib, tiny_case, unit):
    """A NaN in one sample trips the batch-wide guard in the forward; the
    backward kernel reads the forward's flag and passes zero gradient
    through the guarded attention (the bank gets exactly zero), equal to
    autograd of the plain version with its attention output zeroed
    (the guard's path does not depend on the width: tiny width)."""
    r = _check(emu_lib, tiny_case, unit, torch.float32, nan_at=(1, 3, 5))
    assert r.flag == 1 and r.ok, r


def test_kernel_masks_are_the_plain_masks(emu_lib, tiny_case):
    """At dropout 0.5 the kernel's forward equals the plain version fed
    the hash masks of fused_ref, and differs from the unmasked forward:
    kernel and plain version draw the same bits from one counter hash."""
    g, p, bankp, rows, x = tiny_case
    g = g._replace(dropout=0.5)
    rng = R.block_rng(99, 0.5, 0.0)
    train = K.UnitTrain(rng, bankp)
    out, _, _, _ = K.launch_swa(emu_lib, p, x, *rows, g, torch.float32, None,
                                train, GRID)
    plain = K.swa_plain(p, x, *rows, g, torch.float32, train)[0]
    eval_out = K.swa_plain(p, x, *rows, g, torch.float32)[0]
    assert K.within_tolerance(out, plain)
    assert (out - eval_out).abs().max() > 0.1 * eval_out.abs().max()




@pytest.fixture(scope="module")
def flagship_case():
    return _case("flagship_width")


def _check_mma(emu_lib, case, unit, **kw):
    """_check in bf16 at hqavit_c100's width, which must take the unit's
    tensor-core forward and backward entries."""
    K.reset_launches()
    r = _check(emu_lib, case, unit, torch.bfloat16, **kw)
    assert K.ROUTES[f"{unit}_bwd_mma"] == 1 and K.ROUTES[f"{unit}_bwd"] == 0
    assert K.ROUTES[f"{unit}_mma"] == 1 and K.ROUTES[unit] == 0
    return r


@pytest.mark.parametrize("unit", MMA_BWD)
def test_mma_backward_nan_guard_bf16(emu_lib, flagship_case, unit):
    """The tensor-core backward replays a tripped guard: no gradient
    through the attention, exactly zero for the bank."""
    r = _check_mma(emu_lib, flagship_case, unit, nan_at=(1, 3, 5))
    assert r.flag == 1 and r.ok, r


@pytest.mark.parametrize("unit", MMA_BWD)
def test_mma_backward_short_bank(emu_lib, flagship_case, unit):
    """12 bank rows: the keys past them are masked in the recompute and
    get no gradient."""
    r = _check_mma(emu_lib, flagship_case, unit, bank_s=12)
    assert r.ok, r


@pytest.mark.parametrize("unit", MMA_BWD)
def test_mma_backward_route(emu_lib, unit):
    """bwd_entry takes the tensor-core entry exactly where the error
    function admits the geometry: at n=16 bf16 at hqavit_c100's widths
    (float32 and the tiny width, whose reason names C, take the CUDA-core
    entry); at n=64 the n=64 entry in bf16 at hqavit_tiny_in's widths,
    and a named ValueError for float32 or other widths.  The tensor-core C
    entries return ERR_ARGS (1) for a width, dtype or geometry they do not
    take, before they touch an argument: the n=16 ones for the tiny width,
    float32 and n=64; the n=64 ones for n=16 and float32; the n=64
    training forward for n=16 and eval."""
    error = {"unit_swa": K.swa_bwd_mma_error,
             "unit_msda": K.msda_bwd_mma_error,
             "unit_cga": K.cga_bwd_mma_error,
             "unit_cross_tail": K.cross_tail_bwd_mma_error}[unit]
    flagship, tiny = make_geom(_cfg("flagship_width")), make_geom(_cfg("tiny"))
    tin = make_geom(_cfg("tin"))
    assert error(flagship) is None and error(tin) is None
    reason = error(tiny)
    assert reason is not None and "C=192" in reason, reason
    assert error(flagship._replace(bank_s=17)) is not None
    for g, dtype in ((flagship, torch.bfloat16), (flagship, torch.float32),
                     (tiny, torch.bfloat16), (tiny, torch.float32)):
        mma = dtype == torch.bfloat16 and error(g) is None
        assert K.bwd_entry(unit, g, dtype) == unit + ("_bwd_mma" if mma
                                                      else "_bwd")
    assert K.bwd_entry(unit, tin, torch.bfloat16) == f"{unit}_bwd_mma64"
    with pytest.raises(ValueError, match="float32 at n=64 in training"):
        K.bwd_entry(unit, tin, torch.float32)
    with pytest.raises(ValueError, match="C=192"):
        K.bwd_entry(unit, make_geom(_cfg("tin").replace(embed_dim=96)),
                    torch.bfloat16)
    route = {"unit_swa": K.swa_route, "unit_msda": K.msda_route,
             "unit_cga": K.cga_route,
             "unit_cross_tail": K.cross_tail_route}[unit]
    assert route(tin, torch.bfloat16, True) == f"{unit}_mma_train64"
    assert route(tin, torch.bfloat16) == f"{unit}_mma"
    assert route(flagship, torch.bfloat16, True) == f"{unit}_mma"
    p = _case("tiny")[1]
    rng = R.block_rng(1, 0.1, 0.1)
    for suffix, cases in (("_bwd_mma", ((tiny, 1), (flagship, 0), (tin, 1))),
                          ("_bwd_mma64", ((flagship, 1), (tin, 0)))):
        entry = getattr(emu_lib, f"qv_{unit}{suffix}")
        for g, is_bf16 in cases:
            args = K._ENTRY[f"{unit}_bwd"]()
            args.f.d = K._dims(g, B, p, GRID.blocks, GRID.reduce, rng)
            assert entry(ctypes.byref(args), None, is_bf16, None) == 1
    entry = getattr(emu_lib, f"qv_{unit}_mma_train64")
    for g, is_bf16, r in ((flagship, 1, rng), (tin, 0, rng), (tin, 1, None)):
        args = K._ENTRY[unit]()
        args.d = K._dims(g, B, p, GRID.blocks, GRID.reduce, r)
        assert entry(ctypes.byref(args), None, None, is_bf16, None) == 1
