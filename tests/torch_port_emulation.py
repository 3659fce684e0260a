"""The kernels' own source (qavit_tpu_torch/csrc) compiled for the host
with g++ against tests/cuda_emulation/qv_emulate.h, for the emulated
kernel tests (``tests/test_torch_port_*kernels_emulated*.py``).

It also holds the cases the training kernels' files share: seed-made
block weights at three widths (``_case``) and a unit's forward and
backward kernels held against the plain version (``_check``).

The library is built once per hash of its sources, its header and its
command, into the root that the workers of one pytest run share (the
parent of each ``pytest-xdist`` worker's temporary directory; the run's
own directory without xdist): the first worker to need it builds it
while the others wait on a lock, and every emulated file then loads the
same file.

An emulated block is 256 threads that meet at a barrier for every
``__syncthreads`` and every warp-wide call, so a block advances only as
fast as the scheduler wakes all of them; beside other busy processes
(the suite's other workers) a test slowed 10x.  ``two_cores`` pins an
emulated module's process, and so the threads it starts, to two CPUs
chosen by its worker's index for the module's duration."""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
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
FLAGS = ("-std=c++20", "-O1", "-shared", "-fPIC", "-DQV_EMULATE")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest(gxx: str) -> str:
    h = hashlib.sha256(" ".join((gxx,) + FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")) + sorted(EMU.glob("*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


@pytest.fixture(autouse=True, scope="module")
def two_cores():
    """The module's process pinned to two CPUs (worker i takes the i-th
    pair of its allowed CPUs, wrapping around), restored after."""
    allowed = sorted(os.sched_getaffinity(0))
    if len(allowed) <= 2:
        yield
        return
    worker = os.environ.get("PYTEST_XDIST_WORKER", "gw0")[2:]
    k = 2 * int(worker) % len(allowed) if worker.isdigit() else 0
    os.sched_setaffinity(0, {allowed[k], allowed[(k + 1) % len(allowed)]})
    yield
    os.sched_setaffinity(0, allowed)


def emulation_library(tmp_path_factory) -> ctypes.CDLL:
    """The bound host library (``fused_kernels.bind``); skips without
    g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is needed to compile the kernels for the host")
    base = tmp_path_factory.getbasetemp()
    root = base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
    root = root / "qv_emu"
    root.mkdir(parents=True, exist_ok=True)
    out = root / f"libqv_emu_{_digest(gxx)}.so"
    with open(root / f"{out.name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.exists():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [gxx, *FLAGS, "-x", "c++", f"-I{EMU}",
                   *map(str, _sources()), "-o", str(tmp), "-lpthread"]
            subprocess.run(cmd, check=True, capture_output=True)
            os.replace(tmp, out)
    return K.bind(ctypes.CDLL(str(out)))


# --- the training kernels' cases ---

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

MMA_BWD = ["unit_swa", "unit_msda", "unit_cga", "unit_cross_tail"]


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
