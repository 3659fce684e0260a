"""Checks of the unit kernels in training against their plain versions,
shared by the tests (kernels compiled for the host) and ``chip_smoke.py``
(kernels on the card).

:func:`check_unit` runs one unit's train-mode forward kernel and its
backward kernel on the same inputs, masks and cotangents as the plain
version and autograd through it, and reports the worst errors against the
stated tolerances (``fused_kernels.TOLERANCE`` for the outputs, the bank
partials and the input cotangents' dtype; ``GRAD_TOLERANCE`` for the
gradients).  :func:`unit_inputs` makes one set of inputs for every unit.
"""

from __future__ import annotations

import contextlib
from typing import List, NamedTuple, Optional
from unittest import mock

import torch

from qavit_tpu_torch.kernels import fused_kernels as K
from qavit_tpu_torch.kernels import fused_ref as R
from qavit_tpu_torch.kernels.fused_ref import FusedGeom

# stated tolerance of the float32 bank partials: sums over the batch in
# another order (per block, then over blocks) than the plain matmul
PARTIAL_TOLERANCE = 1e-4


class UnitCheck(NamedTuple):
    unit: str
    out_err: float       # worst |kernel - plain| / max|plain| of the outputs
    part_err: float      # same for the bank partials (0 for cross_tail)
    grad_err: float      # worst gradient error / its scale (compare_grads)
    grad_abs: float      # worst gradient |kernel - plain|
    flag: int            # the forward's NaN-guard flag
    ok: bool


def unit_inputs(p, g: FusedGeom, dtype, x: torch.Tensor, bank):
    """{unit: batch inputs} from x [B, n, C] and the bank rows, with the
    later units' inputs made by the plain eval versions."""
    bk, bv = bank
    with torch.no_grad():
        o, xn = K.swa_plain(p, x, bk, bv, g, dtype)
        m = K.msda_plain(p, xn, bk, bv, g, dtype)
        c = K.cga_plain(p, xn, bk, bv, g, dtype)
    return {"unit_swa": (x, bk, bv), "unit_msda": (xn, bk, bv),
            "unit_cga": (xn, bk, bv),
            "unit_cross_tail": (x, xn, o, m, c, bk, bv)}


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    if not torch.equal(torch.isnan(a), torch.isnan(b)):
        return float("inf")
    keep = ~torch.isnan(b)
    if not keep.any():
        return 0.0
    scale = b[keep].abs().max().item()
    err = (a[keep] - b[keep]).abs().max().item()
    return err / scale if scale > 0 else err


def forward_errors(outs, ref, n: int):
    """(worst output error, worst bank-partial error), each relative to
    max|plain|, of a unit's train-mode results ``outs`` (its ``n``
    differentiable outputs, then part_k and part_v where the unit writes
    the bank) against the plain version's ``ref`` in the same layout."""
    out_err = max(_rel(a, b) for a, b in zip(outs[:n], ref[:n]))
    part_err = max((_rel(a, b) for a, b in zip(outs[n:], ref[n:])),
                   default=0.0)
    return out_err, part_err


def _zero_attention(q, k, v, **_):
    return torch.zeros_like(q)


def check_unit(lib, unit: str, p, train: Optional[K.UnitTrain], batch,
               g: FusedGeom, dtype, grid: K.Grid,
               cotangents: List[torch.Tensor], stream=None,
               guard_tripped: bool = False) -> UnitCheck:
    """One unit's forward and backward kernels against the plain version
    (``train=None``: the eval forward and the eval-mode backward).  With
    ``guard_tripped`` the inputs hold a NaN: the kernels must take the
    guarded path, and the reference is autograd of the plain version
    with its attention output forced to zero, the function the guard
    computes (its attention passes zero gradient)."""
    n = K._N_DIFF_OUT[unit]
    inputs = [t.detach() for t in batch]
    keep = {"keep_ws": True} if train is None else {}
    *outs, ws = K._FWD[unit](lib, p, *inputs, g, dtype, stream, train, grid,
                             **keep)
    d_in, wg = K._BWD[unit](lib, p, *inputs, g, dtype, stream, train, grid,
                            ws, *cotangents)
    if torch.cuda.is_available() and inputs[0].is_cuda:
        torch.cuda.synchronize()
    leaves = [t.detach().clone().requires_grad_(t.is_floating_point())
              for t in batch]
    params = K.unit_params(unit, p)
    weights = [t.detach().clone().requires_grad_() for _, t in params]
    pw = _with(p, [path for path, _ in params], weights)
    ctx = (mock.patch.object(R, "attention_core", _zero_attention)
           if guard_tripped else contextlib.nullcontext())
    with ctx:
        ref = K.PLAIN[unit](pw, *leaves, g, dtype, train)
    ref = ref if isinstance(ref, tuple) else (ref,)
    gr = torch.autograd.grad(ref[:n], leaves + weights, cotangents,
                             allow_unused=True)
    parts = list(outs[n]) if len(outs) > n else []
    out_err, part_err = forward_errors(list(outs[:n]) + parts, ref, n)
    pairs = [(a, torch.zeros_like(a) if b is None else b)
             for a, b in zip(d_in, gr[:len(leaves)])]
    pairs += [(wg[path], torch.zeros_like(t) if b is None else b)
              for (path, t), b in zip(params, gr[len(leaves):])]
    grad_abs, grad_err, grads_ok = K.compare_grads(pairs, dtype)
    flag = int(ws[1].item())
    ok = (grads_ok and out_err <= K.TOLERANCE[dtype]
          and part_err <= PARTIAL_TOLERANCE and flag == int(guard_tripped))
    if guard_tripped:       # nothing flows back through the attention
        ok = ok and all(bool((d == 0).all()) for d in d_in[-2:])
    return UnitCheck(unit, out_err, part_err, grad_err, grad_abs, flag, ok)


def _with(p, paths, tensors):
    """A copy of the tree ``p`` with the leaves at ``paths`` replaced."""
    def copy(node):
        return {k: copy(v) for k, v in node.items()} if isinstance(
            node, dict) else node
    out = copy(p)
    for path, t in zip(paths, tensors):
        node = out
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = t
    return out


def random_cotangents(unit: str, batch, dtype,
                      gen: torch.Generator) -> List[torch.Tensor]:
    """Seed-made cotangents of a unit's differentiable outputs."""
    x = batch[0]
    return [torch.randn(x.shape, generator=gen).to(x.device, dtype)
            for _ in range(K._N_DIFF_OUT[unit])]
