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

At hqavit_tiny_in's geometry (C=192, n=64 on an 8x8 grid, four SWA
windows, 40 pooled MSDA rows) the bf16 train-mode forwards and backward
kernels (their own C entries, qv_unit_*_mma_train64 and
qv_unit_*_bwd_mma64) are held the same way over 5 samples and 3 blocks
(the SWA backward's passes of two windows end short, the others' passes
of a sample end on blocks of one and two samples), with the guard
tripped, with 12 bank rows, with their masks at dropout 0.5, and their
routes and ERR_ARGS are checked."""

import ctypes
import functools
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from qavit_tpu_torch.configs import get_preset
from qavit_tpu_torch.kernels import fused_kernels as K
from qavit_tpu_torch.kernels import fused_ref as R
from qavit_tpu_torch.kernels import unit_checks as C
from qavit_tpu_torch.kernels.build import CSRC
from qavit_tpu_torch.kernels.fused_params import QuadBlockParams
from qavit_tpu_torch.kernels.fused_ref import make_geom
from qavit_tpu_torch.nn.bank import GlobalBankParams
from qavit_tpu_torch.nn.layers import init_weights, param_tree

EMU = Path(__file__).resolve().parent / "cuda_emulation"
B = 3
# samples at each width: at hqavit_c100's, two tiles of the n=16
# tensor-core forwards (4 + 2 samples), so they run on both blocks.  With
# 3 samples (one tile, one block) their bank partials also read 1.1-1.4e-4
# of max|plain| against PARTIAL_TOLERANCE: the kernels' bf16 outputs
# differ from the plain version's in some 0.3% of elements by one ulp, the
# tensor cores' summation order against the CPU's (with the emulated mma
# summing in the CPU's order they are bit-identical), and one such
# element moves a partial by ~5e-4 while max|partial| grows with the batch
SAMPLES = {"tiny": B, "flagship_width": 2 * B, "tin": 5}
GRID = K.Grid(2, 2)
# n=64: three blocks over 5 samples (20 windows: 7, 7 and 6 a block)
GRID64 = K.Grid(3, 2)
UNITS = list(K.UNITS)


@pytest.fixture(scope="module")
def emu_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is needed to compile the kernels for the host")
    out = tmp_path_factory.mktemp("qv_emu_train") / "libqv_emu.so"
    cmd = [gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-DQV_EMULATE",
           "-x", "c++", f"-I{EMU}", *map(str, sorted(CSRC.glob("*.cu"))),
           "-o", str(out), "-lpthread"]
    subprocess.run(cmd, check=True, capture_output=True)
    return K.bind(ctypes.CDLL(str(out)))


def _cfg(width):
    if width == "tin":
        return get_preset("hqavit_tiny_in").model
    cfg = get_preset("hqavit_c100").model
    if width == "tiny":
        cfg = cfg.replace(embed_dim=48, linformer_k=8, msda_pad_len=32)
    return cfg


@functools.lru_cache(maxsize=None)
def _case(width):
    """Seed-made block weights (perturbed off their constant inits), bank
    rows and write projections, and the input x."""
    cfg = _cfg(width)
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
    x = torch.randn(SAMPLES[width], g.n, g.c, generator=gen) * 2
    return g, param_tree(blk), bankp, rows, x


@pytest.fixture(scope="module", params=["tiny", "flagship_width"])
def case(request):
    return _case(request.param)


@pytest.fixture(scope="module")
def tiny_case():
    return _case("tiny")


def _check(emu_lib, case, unit, dtype, rate=0.1, dpr=0.1, nan_at=None,
           bank_s=None, grid=GRID, batch=None):
    g, p, bankp, rows, x = case
    g = g._replace(dropout=rate)
    if bank_s is not None:         # the first bank_s rows (and gate columns)
        g = g._replace(bank_s=bank_s)
        rows = [r[:, :bank_s].contiguous() for r in rows]
        bankp = dict(bankp)
        for k, sl in (("write_gate_kernel", (slice(None), slice(bank_s))),
                      ("write_gate_bias", (slice(bank_s),))):
            bankp[k] = bankp[k][sl].contiguous()
    train = K.UnitTrain(R.block_rng(1234, rate, dpr), bankp)
    if batch is not None:
        x = x[:batch]
    batch = C.unit_inputs(p, g, dtype, x.to(dtype), rows)[unit]
    if nan_at is not None:
        batch = list(batch)
        lead = 1 if unit == "unit_cross_tail" else 0   # x or xn
        batch[lead] = batch[lead].clone()
        batch[lead][nan_at] = float("nan")
    cots = C.random_cotangents(unit, batch, dtype,
                               torch.Generator().manual_seed(5))
    return C.check_unit(emu_lib, unit, p, train, batch, g, dtype, grid, cots,
                        guard_tripped=nan_at is not None)


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


MMA_BWD = ["unit_swa", "unit_msda", "unit_cga", "unit_cross_tail"]


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


@pytest.fixture(scope="module")
def tin_case():
    return _case("tin")


def _check_n64(emu_lib, case, unit, **kw):
    """_check in bf16 at hqavit_tiny_in's geometry, through the unit's
    n=64 training forward and backward entries."""
    K.reset_launches()
    r = _check(emu_lib, case, unit, torch.bfloat16, **kw)
    assert K.ROUTES[f"{unit}_mma_train64"] == 1, K.ROUTES
    assert K.ROUTES[f"{unit}_bwd_mma64"] == 1, K.ROUTES
    assert sum(K.ROUTES.values()) == 2, K.ROUTES
    return r


@pytest.mark.parametrize("unit", MMA_BWD)
def test_n64_train_kernels(emu_lib, tin_case, unit):
    """The n=64 bf16 training forward (outputs, bank partials) and
    backward kernel (every gradient) against the plain version and
    autograd, masks on, 5 samples over 3 blocks."""
    r = _check_n64(emu_lib, tin_case, unit, grid=GRID64)
    assert r.ok, r


@pytest.mark.parametrize("unit", MMA_BWD)
def test_n64_train_nan_guard_and_short_bank(emu_lib, tin_case, unit):
    """n=64: the guard tripped by a NaN in one of 2 samples (zero
    gradient through the attention, zero for the bank), then 12 bank rows
    (the keys past them masked in the forward and the recompute)."""
    r = _check_n64(emu_lib, tin_case, unit, nan_at=(1, 3, 5), batch=2)
    assert r.flag == 1 and r.ok, r
    r = _check_n64(emu_lib, tin_case, unit, bank_s=12, batch=2)
    assert r.ok, r


@pytest.mark.parametrize("unit,width", [
    ("unit_swa", "flagship_width"), ("unit_msda", "flagship_width"),
    ("unit_cga", "flagship_width"), ("unit_swa", "tin"), ("unit_msda", "tin"),
    ("unit_cga", "tin"), ("unit_cross_tail", "tin")])
def test_mma_forward_masks_are_the_plain_masks(emu_lib, unit, width):
    """The tensor-core forwards in training at dropout 0.5 (n=16 and, with
    the cross/tail unit's six masks, n=64): outputs and bank partials
    equal to the plain version fed fused_ref's hash masks within the
    stated tolerances, and the outputs away from the unmasked forward's:
    each element's mask is its own sample's, at its flat index in the JAX
    layout."""
    g, p, bankp, rows, x = _case(width)
    g = g._replace(dropout=0.5)
    dtype = torch.bfloat16
    train = K.UnitTrain(R.block_rng(99, 0.5, 0.1), bankp)
    batch = C.unit_inputs(p, g, dtype, x.to(dtype), rows)[unit]
    n = K._N_DIFF_OUT[unit]
    K.reset_launches()
    *outs, ws = K._FWD[unit](emu_lib, p, *batch, g, dtype, None, train, GRID)
    entry = f"{unit}_mma" + ("_train64" if g.n == 64 else "")
    assert K.ROUTES[entry] == 1 and int(ws[1]) == 0
    ref = K.PLAIN[unit](p, *batch, g, dtype, train)
    ref = ref if isinstance(ref, tuple) else (ref,)
    parts = list(outs[n]) if len(outs) > n else []
    out_err, part_err = C.forward_errors(list(outs[:n]) + parts, ref, n)
    assert out_err <= K.TOLERANCE[dtype] and part_err <= C.PARTIAL_TOLERANCE
    eval_out = K.PLAIN[unit](p, *batch, g, dtype)
    eval_out = eval_out[0] if isinstance(eval_out, tuple) else eval_out
    assert ((outs[0].float() - eval_out.float()).abs().max()
            > 0.1 * eval_out.float().abs().max())
