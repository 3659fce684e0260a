"""The n=64 training kernels' own source (qavit_tpu_torch/csrc),
compiled for the host with g++ against tests/cuda_emulation/qv_emulate.h
(``tests/torch_port_emulation.py``) and driven through the same ctypes
launch functions the card uses, as
``tests/test_torch_port_train_kernels_emulated.py`` does at n=16.

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
import shutil
import subprocess
from unittest import mock

import pytest
import torch

from qavit_tpu_torch.kernels import fused_kernels as K
from qavit_tpu_torch.kernels import fused_ref as R
from qavit_tpu_torch.kernels import unit_checks as C
from qavit_tpu_torch.kernels.build import CSRC
from torch_port_common import one_thread  # noqa: F401 (autouse)
from torch_port_emulation import (EMU, GRID, GRID64, MMA_BWD, _case, _check,
                                  emulation_library)
from torch_port_emulation import two_cores  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def emu_lib(tmp_path_factory):
    return emulation_library(tmp_path_factory)


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
