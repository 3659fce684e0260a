"""Self-test of the tensor-core primitives the bf16 kernels are built from
(``qavit_tpu_torch/csrc/mma.cuh``, kernel ``csrc/mma_selftest.cu``): one
warp loads a 16 x 16 A and a 16 x 16 B through ``ldmatrix`` (B stored
[n][k]) or ``ldmatrix.trans`` (B stored [k][n]) and multiplies them with
two ``mma.sync.m16n8k16`` calls.  The result must equal A @ B of the bf16
values to :data:`TOLERANCE` of its largest entry: the products are exact
in float32 and only the sums' order and width differ.

On the card this checks the inline PTX; compiled for the host against
``tests/cuda_emulation/qv_emulate.h`` it checks that the emulation
rebuilds the fragments as the PTX ISA lays them out.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

TOLERANCE = 1e-6


class MmaTestArgs(ctypes.Structure):
    """Mirror of ``qv::MmaTestArgs`` (csrc/mma_selftest.cu)."""

    _fields_ = [("a", ctypes.c_void_p), ("b", ctypes.c_void_p),
                ("d", ctypes.c_void_p), ("trans", ctypes.c_int)]


def bind(lib: ctypes.CDLL) -> None:
    lib.qv_mma_selftest_struct_size.argtypes = []
    lib.qv_mma_selftest_struct_size.restype = ctypes.c_int
    got = lib.qv_mma_selftest_struct_size()
    if got != ctypes.sizeof(MmaTestArgs):
        raise RuntimeError(f"MmaTestArgs: C size {got} != ctypes size "
                           f"{ctypes.sizeof(MmaTestArgs)}")
    lib.qv_mma_selftest.argtypes = [ctypes.POINTER(MmaTestArgs),
                                    ctypes.c_void_p]
    lib.qv_mma_selftest.restype = ctypes.c_int


def inputs(seed: int, device="cpu"):
    """A [16, 16] and B [16, 16] in bf16 from a numpy seed."""
    rng = np.random.default_rng(seed)
    a, b = (torch.from_numpy(rng.standard_normal((16, 16), np.float32))
            for _ in range(2))
    return a.to(device, torch.bfloat16), b.to(device, torch.bfloat16)


def plain(a: torch.Tensor, b: torch.Tensor, trans: bool) -> torch.Tensor:
    """A @ B of the bf16 values, exact (float64) and rounded to float32;
    B is [k][n] with ``trans``, else [n][k]."""
    bk = b.double() if trans else b.double().T
    return (a.double() @ bk).float()


def run(lib, a: torch.Tensor, b: torch.Tensor, trans: bool,
        stream: Optional[int] = None) -> torch.Tensor:
    """The kernel's A @ B (float32 [16, 16]) on a's device."""
    a, b = a.contiguous(), b.contiguous()
    d = torch.empty(16, 16, dtype=torch.float32, device=a.device)
    args = MmaTestArgs(a.data_ptr(), b.data_ptr(), d.data_ptr(), int(trans))
    rc = lib.qv_mma_selftest(ctypes.byref(args), stream)
    if rc != 0:
        raise RuntimeError(f"mma self-test: launch failed with code {rc}")
    return d


def check(lib, seed: int = 0, stream: Optional[int] = None,
          device="cpu"):
    """[(trans, max abs error, bound)] and whether every case is within
    TOLERANCE x max|A @ B|."""
    a, b = inputs(seed, device)
    rows, ok = [], True
    for trans in (False, True):
        d = run(lib, a, b, trans, stream)
        ref = plain(a.cpu(), b.cpu(), trans)
        err = (d.cpu() - ref).abs().max().item()
        bound = TOLERANCE * ref.abs().max().item()
        rows.append((trans, err, bound))
        ok = ok and err <= bound
    return rows, ok
