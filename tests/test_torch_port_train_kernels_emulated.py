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
qv_unit_*_bwd_mma64) are held the same way over 5 samples and 4 blocks,
the SWA, MSDA and cross/tail forwards on 4 clusters of two CTAs (one
walking two samples; alone at B=1 and at B=3 on two clusters, one a
sample short), the SWA, MSDA and CGA forwards' partials' workspace
filled with NaN first (4 blocks or clusters, one of two samples), the
four backwards on clusters of two CTAs
(fused_kernels.cluster_grid:
SWA 2 clusters of 10 windows, passes of two, 3 and 2 a CTA; MSDA 2, of 3
and 2 samples, a CTA's 2 and 1 or 1 and 1; CGA 4, one ending on a second
sample; cross/tail 2, of 3 and 2 samples), with the guard tripped, with
12 bank rows, with their gradient workspace and scratch filled with NaN
before the launch (every field stored, none read first), with their
masks at dropout 0.5, and their routes and ERR_ARGS are checked.  The
emulator runs a cluster's CTAs at once, each with its own NaN-filled
shared memory, and a CTA reads its partner's as the partner left it at
its last cluster barrier: a halo row or a pair's sum read before that
barrier is NaN (test_cluster_read_before_the_partners_barrier_is_nan,
test_pair_sums_before_the_partners_barrier_are_nan), so a missing
barrier or exchange fails the n=64 tests."""

import contextlib
import ctypes
import functools
import shutil
import subprocess
from unittest import mock
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
# n=64: four blocks over 5 samples; the cluster backwards' launches from
# it: SWA 2 clusters (windows 0, 2, .. 18 and 1, 3, .. 19, five passes),
# MSDA and cross/tail 2 (samples 0, 2, 4 and 1, 3), CGA 4 (samples 0 and
# 4, then one each)
GRID64 = K.Grid(4, 2)
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


@pytest.mark.parametrize("unit", MMA_BWD)
def test_n64_backward_workspace_may_hold_nan(emu_lib, tin_case, unit,
                                            monkeypatch):
    """The n=64 backwards store every field of their gradient slices, and
    write every row of their scratch before they read it: with both
    filled with NaN before each launch, every gradient is still within
    tolerance, with masks and with the guard tripped (2 samples)."""
    grads_init, common = K._Grads.__init__, K._bwd_common

    def nan_workspace(self, *args, **kw):
        grads_init(self, *args, **kw)
        self.gws.fill_(float("nan"))

    def nan_scratch(lc, bc, bank_k, bank_v, ws, grads, scratch=None):
        if scratch is not None:
            scratch.fill_(float("nan"))
        common(lc, bc, bank_k, bank_v, ws, grads, scratch)

    monkeypatch.setattr(K._Grads, "__init__", nan_workspace)
    monkeypatch.setattr(K, "_bwd_common", nan_scratch)
    r = _check_n64(emu_lib, tin_case, unit, batch=2)
    assert r.ok, r
    r = _check_n64(emu_lib, tin_case, unit, nan_at=(1, 3, 5), batch=2)
    assert r.flag == 1 and r.ok, r


def _forward_n64(emu_lib, case, unit, batch, grid, nan_at=None):
    """The n=64 bf16 train-mode forward alone through its entry (masks on,
    5 samples' first ``batch``) against the plain version: (output error,
    partials error, guard flag).  With ``nan_at`` the input holds a NaN and
    the reference is the plain version with its attention output zeroed,
    as the guard's redo computes it."""
    g, p, bankp, rows, x = case
    dtype = torch.bfloat16
    train = K.UnitTrain(R.block_rng(1234, 0.1, 0.1), bankp)
    inputs = list(C.unit_inputs(p, g, dtype, x[:batch].to(dtype), rows)[unit])
    if nan_at is not None:
        lead = 1 if unit == "unit_cross_tail" else 0   # x or xn
        inputs[lead] = inputs[lead].clone()
        inputs[lead][nan_at] = float("nan")
    n = K._N_DIFF_OUT[unit]
    K.reset_launches()
    *outs, ws = K._FWD[unit](emu_lib, p, *inputs, g, dtype, None, train, grid)
    assert K.ROUTES[f"{unit}_mma_train64"] == 1, K.ROUTES
    assert sum(K.ROUTES.values()) == 1, K.ROUTES
    ctx = (mock.patch.object(R, "attention_core", C._zero_attention)
           if nan_at is not None else contextlib.nullcontext())
    with ctx, torch.no_grad():
        ref = K.PLAIN[unit](p, *inputs, g, dtype, train)
    ref = ref if isinstance(ref, tuple) else (ref,)
    parts = list(outs[n]) if len(outs) > n else []
    return (*C.forward_errors(list(outs[:n]) + parts, ref, n), int(ws[1]))


def _forward_n64_nan_partials(emu_lib, case, unit, guard, monkeypatch):
    """_forward_n64 over 5 samples on GRID64 with the per-block (or
    per-cluster) partial slices and their sum filled with NaN before the
    launch, the guard tripped in sample 1 or not: every field of every
    slice must be stored (part_v and the gate sums; part_k is formed once
    after the slices' sum, bank_compress_kernel), the redo restarting
    every slice.  Outputs and partials within tolerance."""
    bank_write = K._bank_write

    def nan_workspace(lc, *args):
        out = bank_write(lc, *args)
        lc.held[-1].fill_(float("nan"))        # the per-block slices
        out.fill_(float("nan"))
        return out

    monkeypatch.setattr(K, "_bank_write", nan_workspace)
    out_err, part_err, flag = _forward_n64(
        emu_lib, case, unit, 5, GRID64, (1, 3, 5) if guard else None)
    assert flag == int(guard)
    assert out_err <= K.TOLERANCE[torch.bfloat16], out_err
    assert part_err <= C.PARTIAL_TOLERANCE, part_err


@pytest.mark.parametrize("guard", [False, True], ids=["masks", "guard"])
def test_n64_cga_forward_partials_workspace_may_hold_nan(emu_lib, tin_case,
                                                         guard, monkeypatch):
    """The n=64 CGA training forward stores every field of its blocks'
    partial slices: 5 samples on 4 blocks (one block two samples), with
    masks, and with the guard tripped (the last block's redo)."""
    _forward_n64_nan_partials(emu_lib, tin_case, "unit_cga", guard,
                              monkeypatch)


@pytest.mark.parametrize("guard", [False, True], ids=["masks", "guard"])
@pytest.mark.parametrize("unit", ["unit_swa", "unit_msda"])
def test_n64_window_forward_partials_workspace_may_hold_nan(
        emu_lib, tin_case, unit, guard, monkeypatch):
    """The n=64 SWA and MSDA training forwards on two-CTA clusters store
    every field of their clusters' partial slices (the pair's sums in
    rank order): 5 samples on 4 clusters (one cluster two samples), with
    masks, and with the guard tripped (the last cluster's redo zeroes
    every other slice)."""
    _forward_n64_nan_partials(emu_lib, tin_case, unit, guard, monkeypatch)


@pytest.mark.parametrize("batch,clusters,nan_at", [
    (1, 1, None), (3, 2, None), (3, 2, (2, 3, 5))],
    ids=["B1", "B3_short_last_cluster", "B3_guard"])
def test_n64_cross_tail_forward_on_clusters(emu_lib, tin_case, batch,
                                            clusters, nan_at):
    """The n=64 cross/tail training forward on its two-CTA clusters (a
    sample a cluster at a time, the dwconv's halo row from the partner):
    one sample on one cluster, and three on two clusters, the last of
    which walks one sample fewer, masks on; with the guard tripped in the
    last sample, the last cluster redoes all three."""
    grid = K.Grid(clusters, 2)
    assert K.cluster_grid("unit_cross_tail_mma_train64", grid,
                          batch).blocks == clusters
    out_err, _, flag = _forward_n64(emu_lib, tin_case, "unit_cross_tail",
                                    batch, grid, nan_at)
    assert flag == int(nan_at is not None)
    assert out_err <= K.TOLERANCE[torch.bfloat16], out_err


@pytest.mark.parametrize("batch,clusters,nan_at", [
    (1, 1, None), (3, 2, None), (3, 2, (2, 3, 5))],
    ids=["B1", "B3_short_last_cluster", "B3_guard"])
@pytest.mark.parametrize("unit", ["unit_swa", "unit_msda"])
def test_n64_window_forward_on_clusters(emu_lib, tin_case, unit, batch,
                                        clusters, nan_at):
    """The n=64 SWA and MSDA training forwards on their two-CTA clusters
    (a sample a cluster at a time; SWA's CTAs two windows each, MSDA's
    kc | vc formed half by each CTA and exchanged, the gate's softmax
    through the pair's maxima and sums): one sample on one cluster, and
    three on two clusters, the last of which walks one sample fewer, masks
    on; with the guard tripped in the last sample, the last cluster redoes
    all three.  Outputs and bank partials within tolerance."""
    grid = K.Grid(clusters, 2)
    assert K.cluster_grid(f"{unit}_mma_train64", grid,
                          batch).blocks == clusters
    out_err, part_err, flag = _forward_n64(emu_lib, tin_case, unit, batch,
                                           grid, nan_at)
    assert flag == int(nan_at is not None)
    assert out_err <= K.TOLERANCE[torch.bfloat16], out_err
    assert part_err <= C.PARTIAL_TOLERANCE, part_err


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


def test_cluster_grid(monkeypatch):
    """The two-CTA-cluster entries launch as many clusters as the train
    grid's SMs hold at once (the SWA, MSDA and cross/tail backwards one CTA
    an SM; the CGA backward and the n=64 SWA, MSDA and cross/tail
    train-mode forwards two), at most one a work item (SWA's a window, four a sample;
    the others' a sample), a slice each; on a card SWA's SMs are those of
    its windows, at most the card's; every other entry keeps the train
    grid."""
    big, small = K.Grid(132, 528), K.Grid(4, 2)
    for entry in ("unit_swa_bwd_mma64", "unit_msda_bwd_mma64"):
        assert K.cluster_grid(entry, big, 1024) == (66, 528)
        assert K.cluster_grid(entry, K.Grid(128, 528), 128) == (64, 528)
        assert K.cluster_grid(entry, small, 5) == (2, 2)
        assert K.cluster_grid(entry, small, 5, torch.device("cpu")) == (2, 2)
    assert K.cluster_grid("unit_swa_bwd_mma64", K.Grid(1, 2), 1) == (1, 2)
    assert K.cluster_grid("unit_msda_bwd_mma64", K.Grid(1, 2), 1) == (1, 2)
    # on a card of 132 SMs at B=128 (128 blocks of the train grid): SWA's
    # 512 windows fill every SM, 66 clusters; the others keep one SM a
    # sample (MSDA and cross/tail 64 clusters, CGA 128, two CTAs an SM);
    # a smaller grid stays the SMs of its windows
    monkeypatch.setattr(K, "_sm_count", lambda device: 132)
    card, b128 = torch.device("cuda"), K.Grid(128, 528)
    assert K.cluster_grid("unit_swa_bwd_mma64", b128, 128, card) == (66, 528)
    assert K.cluster_grid("unit_swa_bwd_mma64", big, 1024, card) == (66, 528)
    assert K.cluster_grid("unit_swa_bwd_mma64", K.Grid(3, 12), 9,
                          card) == (6, 12)
    assert K.cluster_grid("unit_msda_bwd_mma64", b128, 128,
                          card) == (64, 528)
    assert K.cluster_grid("unit_cross_tail_bwd_mma64", b128, 128,
                          card) == (64, 528)
    assert K.cluster_grid("unit_cga_bwd_mma64", b128, 128, card) == (128, 528)
    assert K.cluster_grid("unit_cga_bwd_mma64", K.Grid(3, 12), 9,
                          card) == (3, 12)
    assert K.cluster_grid("unit_cross_tail_bwd_mma64", big, 1024) == (66, 528)
    assert K.cluster_grid("unit_cga_bwd_mma64", big, 1024) == (132, 528)
    assert K.cluster_grid("unit_cross_tail_bwd_mma64", K.Grid(128, 528),
                          128) == (64, 528)
    assert K.cluster_grid("unit_cga_bwd_mma64", K.Grid(128, 528),
                          128) == (128, 528)
    assert K.cluster_grid("unit_cross_tail_bwd_mma64", small, 5) == (2, 2)
    assert K.cluster_grid("unit_cga_bwd_mma64", small, 5) == (4, 2)
    assert K.cluster_grid("unit_cga_bwd_mma64", small, 1) == (1, 2)
    assert K.cluster_grid("unit_cross_tail_bwd_mma64", K.Grid(1, 2),
                          1) == (1, 2)
    # the n=64 train-mode SWA, MSDA and cross/tail forwards: two CTAs an
    # SM, a cluster a sample, at most one an SM of the train grid
    for entry in ("unit_swa_mma_train64", "unit_msda_mma_train64",
                  "unit_cross_tail_mma_train64"):
        assert K.cluster_grid(entry, b128, 128, card) == (128, 528)
        assert K.cluster_grid(entry, big, 1024, card) == (132, 528)
        assert K.cluster_grid(entry, small, 5) == (4, 2)
        assert K.cluster_grid(entry, small, 1) == (1, 2)
    for entry in ("unit_swa_bwd_mma", "unit_msda_bwd_mma",
                  "unit_cga_bwd_mma", "unit_cross_tail_bwd_mma",
                  "unit_cga_mma_train64"):
        assert K.cluster_grid(entry, big, 1024) is big


# A cluster of two CTAs: each writes 8 rows of its shared memory (its rank
# plus one), then reads its partner's same rows before the cluster barrier
# and again after it
_HALO_PROBE = r"""
#include "cluster.cuh"
namespace qv {
__global__ void halo_probe(float* out) {
  QV_SMEM_DECL
  const unsigned r = cluster_rank();
  float* o = out + r * 2 * 768;
  for (int i = threadIdx.x; i < 768; i += NTHREADS) qv_smem[i] = r + 1.f;
  __syncthreads();
  const float* peer = cluster_peer(qv_smem, r ^ 1u);
  for (int i = threadIdx.x; i < 768; i += NTHREADS) o[i] = peer[i];
  cluster_sync();
  peer = cluster_peer(qv_smem, r ^ 1u);
  for (int i = threadIdx.x; i < 768; i += NTHREADS) o[768 + i] = peer[i];
  cluster_sync();
}
}  // namespace qv
extern "C" int halo_probe(float* out) {
  return qv_launch_cluster(qv::halo_probe, out, 768 * 4, nullptr, 1, 2);
}
"""


def test_cluster_read_before_the_partners_barrier_is_nan(tmp_path):
    """The emulator's clusters: a CTA reading its partner's halo rows
    before the partner's cluster barrier sees the NaN fill, not the rows
    the partner wrote; after the barrier it sees them.  So a kernel whose
    halo read no barrier orders fails its emulated tests."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is needed to compile the kernels for the host")
    src = tmp_path / "halo_probe.cu"
    src.write_text(_HALO_PROBE)
    lib = tmp_path / "halo_probe.so"
    subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC",
                    "-DQV_EMULATE", "-x", "c++", f"-I{EMU}", f"-I{CSRC}",
                    str(src), "-o", str(lib), "-lpthread"], check=True,
                   capture_output=True)
    probe = ctypes.CDLL(str(lib)).halo_probe
    probe.argtypes = [ctypes.c_void_p]
    out = torch.zeros(2, 2, 768)
    assert probe(out.data_ptr()) == 0
    assert torch.isnan(out[:, 0]).all()              # before the barrier
    assert torch.equal(out[0, 1], torch.full((768,), 2.0))
    assert torch.equal(out[1, 1], torch.full((768,), 1.0))


# A cluster of two CTAs: each leaves 600 floats (rank r: i + 1000 r) in
# its shared memory and adds the pair's through pair_sums into out,
# before the cluster barrier and again after it; each element is stored by
# one CTA, which marks it in `by`
_PAIR_PROBE = r"""
#include "cluster.cuh"
namespace qv {
__global__ void pair_probe(float* out) {
  QV_SMEM_DECL
  const unsigned r = cluster_rank();
  for (int i = threadIdx.x; i < 600; i += NTHREADS)
    qv_smem[i] = i + 1000.f * r;
  __syncthreads();
  pair_sums(qv_smem, 600, [&](int i, float v) { out[i] = v; });
  cluster_sync();
  pair_sums(qv_smem, 600, [&](int i, float v) {
    out[600 + i] = v;
    out[1200 + i] = r;
  });
  cluster_sync();
}
}  // namespace qv
extern "C" int pair_probe(float* out) {
  return qv_launch_cluster(qv::pair_probe, out, 600 * 4, nullptr, 1, 2);
}
"""


def test_pair_sums_before_the_partners_barrier_are_nan(tmp_path):
    """The n=64 SWA and MSDA backwards' shared tail (pair_sums in
    csrc/cluster.cuh): read before the cluster barrier that follows the
    partner's writes, the pair's sums are NaN in the emulator (a mutation
    that drops that barrier fails); after it each element is rank 0's
    plus rank 1's, stored once, half of them by each CTA."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is needed to compile the kernels for the host")
    src = tmp_path / "pair_probe.cu"
    src.write_text(_PAIR_PROBE)
    lib = tmp_path / "pair_probe.so"
    subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC",
                    "-DQV_EMULATE", "-x", "c++", f"-I{EMU}", f"-I{CSRC}",
                    str(src), "-o", str(lib), "-lpthread"], check=True,
                   capture_output=True)
    probe = ctypes.CDLL(str(lib)).pair_probe
    probe.argtypes = [ctypes.c_void_p]
    out = torch.zeros(3, 600)
    assert probe(out.data_ptr()) == 0
    assert torch.isnan(out[0]).all()                 # before the barrier
    assert torch.equal(out[1], 2 * torch.arange(600.0) + 1000.0)
    by = out[2]
    assert (by == 0).sum() == 344 and (by == 1).sum() == 256
    assert torch.equal(by[:256], torch.zeros(256))
    assert torch.equal(by[256:512], torch.ones(256))
