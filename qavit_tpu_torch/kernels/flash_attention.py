"""Small-KV attention as a hand-written CUDA kernel for Hopper
(``qavit_tpu_torch/csrc/flash_attention.cu``: in bf16 on the tensor cores,
in float32 on the CUDA cores), beside its plain PyTorch version.

Counterpart of ``qavit_tpu/kernels/flash_attention.py:74`` (the TPU's
Pallas kernel): ``softmax(q k^T / sqrt(D)) v`` on ``[B, N, H, D]``
tensors, float32 scores and softmax, optional probability dropout,
probabilities rounded to v's dtype before the float32 PV product, the
output in q's dtype.  The kernel reads q, k and v in place through their
strides (the last axis contiguous; a batch stride of 0 is allowed), so
the dispatch makes no transposed copies.

Dropout draws its keep bits from a counter hash of each probability's
flat index in ``[B, H, Nq, Nkv]`` salted by ``salt``
(``fused_ref.mask_bits``), in the kernel and in :func:`plain` alike.

:func:`flash_attention` runs :func:`plain` when q lies on the CPU; on a
CUDA tensor it checks the inputs and launches the kernel, or raises.
Every launch adds one to ``LAUNCHES["flash_attention"]``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import numpy as np
import torch

from qavit_tpu_torch.kernels import fused_kernels as K
from qavit_tpu_torch.kernels import fused_ref as R

# launches of the kernel since the last reset (plain runs do not count)
LAUNCHES = {"flash_attention": 0}
QUERY_TILE = 64           # queries per float32 block (csrc FA_QT)
KV_RANGE = (16, 144)      # keys per (batch, head) slice the kernel takes
D_RANGE = (32, 64)        # head widths the kernel takes


def reset_launches() -> None:
    LAUNCHES["flash_attention"] = 0


def scale(d: int) -> float:
    """1 / sqrt(d) as a float32 value, the factor the scores are
    multiplied by (``attention.py:36``)."""
    return float(np.float32(1.0 / math.sqrt(d)))


def keep_mask(salt: int, rate: float, shape, device) -> torch.Tensor:
    """The keep-mask [B, H, Nq, Nkv] of probability dropout at ``rate``."""
    n = int(np.prod(shape))
    return (R.mask_bits(salt & 0xFFFFFFFF, n, device)
            >= R.threshold(rate)).reshape(shape)


def plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          rate: float = 0.0, salt: int = 0) -> torch.Tensor:
    """The plain version: q [B, Nq, H, D], k and v [B, Nkv, H, D]."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          k.float()) * scale(q.shape[-1])
    probs = torch.softmax(scores, dim=-1)
    if rate > 0.0:
        keep = keep_mask(salt, rate, probs.shape, probs.device)
        probs = torch.where(keep, probs / R.keep_f32(rate), 0.0)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(q.dtype)


class FlashArgs(ctypes.Structure):
    """Mirror of ``qv::FlashArgs`` (csrc/flash_attention.cu)."""

    _fields_ = ([(n, ctypes.c_void_p) for n in ("q", "k", "v", "o")]
                + [(f"{t}_s{a}", ctypes.c_longlong) for t in "qkv"
                   for a in "bnh"]
                + [(n, ctypes.c_int) for n in ("B", "H", "nq", "nkv", "d",
                                               "q_tiles")]
                + [("scale", ctypes.c_float), ("drop_on", ctypes.c_int),
                   ("thr", ctypes.c_uint), ("keep", ctypes.c_float),
                   ("salt", ctypes.c_uint)])


def bind(lib: ctypes.CDLL) -> None:
    """Declare the kernel's C entry points and check the struct layout."""
    lib.qv_flash_struct_size.argtypes = []
    lib.qv_flash_struct_size.restype = ctypes.c_int
    got = lib.qv_flash_struct_size()
    if got != ctypes.sizeof(FlashArgs):
        raise RuntimeError(f"FlashArgs: C size {got} != ctypes size "
                           f"{ctypes.sizeof(FlashArgs)}")
    lib.qv_flash_attention.argtypes = [ctypes.POINTER(FlashArgs),
                                       ctypes.c_int, ctypes.c_void_p]
    lib.qv_flash_attention.restype = ctypes.c_int
    lib.qv_flash_smem.argtypes = [ctypes.POINTER(FlashArgs), ctypes.c_int]
    lib.qv_flash_smem.restype = ctypes.c_int


def input_error(q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor) -> Optional[str]:
    """Why the kernel cannot take these inputs (None if it can)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        return "q, k and v must be [B, N, H, D]"
    b, nq, h, d = q.shape
    if tuple(k.shape) != tuple(v.shape) or (k.shape[0], k.shape[2],
                                            k.shape[3]) != (b, h, d):
        return (f"k and v must be [B, Nkv, H, D] with q's B, H, D; got q "
                f"{tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            q.dtype == k.dtype == v.dtype):
        return (f"q, k, v must share a dtype, float32 or bfloat16; got "
                f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        return "q, k and v must be on one device"
    nkv = k.shape[1]
    if not (KV_RANGE[0] <= nkv <= KV_RANGE[1] and D_RANGE[0] <= d <= D_RANGE[1]
            and nq >= 1):
        return (f"the kernel takes {KV_RANGE[0]}-{KV_RANGE[1]} keys and head "
                f"widths {D_RANGE[0]}-{D_RANGE[1]}; got Nkv {nkv}, D {d}, "
                f"Nq {nq}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        return "the head axis of q, k and v must be contiguous"
    if b * h * -(-nq // QUERY_TILE) >= 2 ** 31:
        return f"too many blocks for one launch (B {b}, H {h}, Nq {nq})"
    return None


def _args(q, k, v, rate: float, salt: int) -> FlashArgs:
    """The kernel's arguments (all but the output pointer), or raise;
    built in one call, which costs a third of setting the fields one by
    one (the wrapper's host time is of the order of a bf16 launch)."""
    err = input_error(q, k, v)
    if err is not None:
        raise ValueError(f"flash_attention: {err}")
    b, nq, h, d = q.shape
    drop = rate > 0.0
    return FlashArgs(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        b, h, nq, k.shape[1], d, -(-nq // QUERY_TILE), scale(d), int(drop),
        R.threshold(rate) if drop else 0, R.keep_f32(rate) if drop else 0.0,
        salt & 0xFFFFFFFF if drop else 0)


def smem_bytes(lib, q, k, v) -> int:
    """Dynamic shared memory of one launch on these inputs, per block."""
    return lib.qv_flash_smem(ctypes.byref(_args(q, k, v, 0.0, 0)),
                             int(q.dtype == torch.bfloat16))


def launch(lib, q, k, v, rate: float = 0.0, salt: int = 0,
           stream: Optional[int] = None) -> torch.Tensor:
    """Launch the kernel on ``stream``; returns o [B, Nq, H, D]."""
    a = _args(q, k, v, rate, salt)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    a.o = o.data_ptr()
    rc = lib.qv_flash_attention(ctypes.byref(a),
                                int(q.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed with "
                           f"code {rc}")
    return o


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    rate: float = 0.0, salt: int = 0) -> torch.Tensor:
    """Attention of q [B, Nq, H, D] over k, v [B, Nkv, H, D] with
    probability dropout at ``rate`` (mask salted by ``salt``)."""
    if q.device.type == "cpu":
        return plain(q, k, v, rate, salt)
    lib, stream = K._cuda(q, "flash_attention")
    o = launch(lib, q, k, v, rate, salt, stream)
    LAUNCHES["flash_attention"] += 1
    return o
