"""The four fused-block units, forward and backward, as hand-written CUDA
kernels for Hopper (``qavit_tpu_torch/csrc/unit_*.cu``).

Counterpart of ``qavit_tpu/kernels/fused_kernels.py`` (the TPU's Pallas
units ``core_swa``, ``core_msda``, ``core_cga``, ``core_cross_tail``, each
a ``fused_pallas.py`` forward kernel with a recompute backward kernel):

    unit_swa         norm1 + SWA branch     -> out_swa, xn (+ bank partials)
    unit_msda        MSDA branch            -> out_msda (+ bank partials)
    unit_cga         CGA branch             -> out_cga (+ bank partials)
    unit_cross_tail  cross branch + tail    -> block output

Each wrapper takes the block's parameter tree (``fused_params``) and runs
the unit's plain PyTorch version when its input lies on the CPU.  On a
CUDA tensor it checks device, dtype, shape and contiguity, allocates its
outputs and launches its kernel on the current stream, or raises.  In
training (``train=UnitTrain(...)``) a unit is a ``torch.autograd.Function``:
the forward kernel saves only the unit's inputs, and the backward kernel
``unit_*_bwd`` recomputes the unit in-kernel with the same masks.  In
eval, where autograd needs the unit's VJP (grad mode on and an input or
weight requiring grad: Grad-CAM, a gradient of the eval forward), the
unit is :class:`_EvalUnit`: the eval forward's own kernel, then the
backward kernel with ``d.train`` off (no masks, no bank partials; JAX's
``make_cores(train=False)``), or a named ValueError before any launch
where the backward kernels do not take the geometry
(:func:`eval_vjp_error`).  Every launch adds one to ``LAUNCHES[name]``.
The kernels take the geometries of
:data:`EVAL_GEOMETRIES` (training: :data:`TRAIN_GEOMETRIES`); any other
raises, naming the reason (:func:`kernel_geometry_error`).  At n=64 in
bf16 the SWA, MSDA, CGA and cross/tail units run on the tensor cores, in
eval and in training (``swa_mma_kernel``, ``msda_mma_kernel``,
``cga_mma_kernel``, ``cross_tail_mma_kernel``; training through their
own C entries ``qv_unit_*_mma_train64``, the SWA, MSDA and cross/tail
ones' ``swa_train64_kernel``, ``msda_train64_kernel`` and
``cross_tail_train64_kernel`` on clusters of two CTAs a sample,
:data:`CLUSTER_FWD`), and so do their backward kernels
(``swa_bwd_mma_kernel<4>``, ``msda_bwd_mma64_kernel``,
``cga_bwd_mma64_kernel``, ``cross_tail_bwd_mma64_kernel``, on clusters of
two CTAs, :func:`cluster_grid`; entries ``qv_unit_*_bwd_mma64``), for the
widths :func:`swa_mma_error`,
:func:`msda_mma_error`, :func:`cga_mma_error`,
:func:`cross_tail_mma_error` and the ``*_bwd_mma_error`` functions name;
other widths, and float32 in training, raise.  At n=16 in bf16
at hqavit_c100's widths the four forwards run on the tensor cores in eval
and in training (``swa_mma_kernel``, ``msda_mma16_kernel``,
``cga_mma_kernel``, ``cross_tail_mma_kernel``, four samples to a tile;
:func:`swa_route`, :func:`msda_route`, :func:`cga_route`,
:func:`cross_tail_route`), and so do the four backward kernels
(``swa_bwd_mma_kernel``, ``msda_bwd_mma_kernel``, ``cga_bwd_mma_kernel``,
``cross_tail_bwd_mma_kernel``; :func:`swa_bwd_mma_error`,
:func:`msda_bwd_mma_error`, :func:`cga_bwd_mma_error`,
:func:`cross_tail_bwd_mma_error`); float32, and bf16 at other n=16
widths, take the CUDA-core kernels (the route is picked by dtype and
widths before the launch, :func:`bwd_entry`).  At n=256 in sixteen
windows (qavit_v2_extreme_tin) every unit runs in bf16 only, through its
own C entries ``qv_unit_*_mma256`` (eval), ``*_mma_train256`` and
``*_bwd_mma256``, each with a scratch buffer (:func:`_scratch256`): SWA
on the n=64 tensor-core bodies with a 16x16 grid (``csrc/unit_swa256.cu``,
backward ``swa_bwd_mma_kernel<16>``), the others as sequences of the
hand-written kernels of ``csrc/n256_ops.cuh`` (``csrc/unit_*256.cu``).
``ROUTES`` counts the launches of each C entry.
"""

from __future__ import annotations

import ctypes
import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from qavit_tpu_torch.kernels import build
from qavit_tpu_torch.kernels import fused_ref as R
from qavit_tpu_torch.kernels.fused_ref import FusedGeom

Params = Dict[str, Any]

UNITS = ("unit_swa", "unit_msda", "unit_cga", "unit_cross_tail")
# launches of each kernel since the last reset (plain runs do not count)
LAUNCHES = {n: 0 for n in UNITS + tuple(f"{u}_bwd" for u in UNITS)}
# launches of each C entry qv_{name} since the last reset, which shows the
# route a launch took: the units' CUDA-core entries, the bf16 forward
# tensor-core ones (n=64 eval and n=16: _mma; n=64 training:
# _mma_train64), and the train backward tensor-core ones (n=16: _bwd_mma;
# n=64: _bwd_mma64)
_MMA_FWD = tuple(f"{u}_mma" for u in UNITS) + tuple(
    f"{u}_mma_train64" for u in UNITS)
_MMA_BWD = tuple(f"{u}_bwd_mma" for u in UNITS) + tuple(
    f"{u}_bwd_mma64" for u in UNITS)
# n=256 (qavit_v2_extreme_tin): eval _mma256, training _mma_train256, the
# backward _bwd_mma256; each takes a scratch buffer beside its weights
_MMA_FWD256 = tuple(f"{u}_mma256" for u in UNITS) + tuple(
    f"{u}_mma_train256" for u in UNITS)
_MMA_BWD256 = tuple(f"{u}_bwd_mma256" for u in UNITS)
ROUTES = {n: 0 for n in UNITS + tuple(f"{u}_bwd" for u in UNITS)
          + _MMA_FWD + _MMA_BWD + _MMA_FWD256 + _MMA_BWD256}


# stated tolerance of a kernel against its plain version, as a fraction of
# the largest |output| of the plain version: float32 differs by the order
# of sums and by expf / erff / rsqrtf against PyTorch's; bf16 allows two
# bf16 ulps of the largest output (a rounding point that lands on the
# other side of a tie in one intermediate)
TOLERANCE = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -6}


def max_abs_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    return (out.float() - ref.float()).abs().max().item()


def within_tolerance(out: torch.Tensor, ref: torch.Tensor) -> bool:
    bound = TOLERANCE[ref.dtype] * ref.float().abs().max().item()
    return bool(torch.isfinite(out).all()) and max_abs_err(out, ref) <= bound


# stated tolerance of a backward kernel's gradients against autograd of
# the plain version, per gradient tensor, as a fraction of max|plain
# gradient|.  float32: the per-block partial sums over the batch and the
# kernels' summation order against PyTorch's (~1e-6 relative), with room
# for gradients that are sums of many cancelling terms.  bf16: autograd
# rounds every cotangent that meets a bf16 tensor to bf16 (and the weight
# gradients of the bf16 weight copies), while the kernel keeps its
# cotangents in float32: a few bf16 ulps (2**-8 each) compound over the
# unit's ~10 rounding points, and more where a gradient is a sum with
# cancellation over the whole batch (the fusion weights, gamma: up to
# 1.7e-2 of their scale in the host-compiled kernels).  A gradient that
# is zero in exact arithmetic holds only roundoff (the cross branch's key
# bias: a vector added to every key shifts all of a query's scores alike,
# which the softmax ignores), so the scale is at least GRAD_FLOOR x the
# unit's largest plain gradient.
GRAD_TOLERANCE = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -4}
GRAD_FLOOR = 1e-3


def compare_grads(pairs, dtype) -> Tuple[float, float, bool]:
    """(worst abs error, worst error / its bound's scale, all within
    GRAD_TOLERANCE) over (kernel gradient, plain gradient) pairs of one
    unit; NaNs must sit where the plain gradient has them."""
    fins = [r.float()[~torch.isnan(r.float())] for _, r in pairs]
    unit_max = max((f.abs().max().item() for f in fins if f.numel()),
                   default=0.0)
    worst, worst_rel, ok = 0.0, 0.0, True
    for (o, r), fin in zip(pairs, fins):
        o, r = o.float(), r.float()
        nan = torch.isnan(r)
        if not torch.equal(torch.isnan(o), nan):
            ok = False
            continue
        if fin.numel() == 0:
            continue
        scale = max(fin.abs().max().item(), GRAD_FLOOR * unit_max)
        err = (o[~nan] - fin).abs().max().item()
        worst = max(worst, err)
        worst_rel = max(worst_rel, err / scale if scale > 0 else 0.0)
        ok = ok and err <= GRAD_TOLERANCE[dtype] * scale
    return worst, worst_rel, ok


class UnitTrain(NamedTuple):
    """What a unit needs in training: the block's mask salts and rates,
    and the bank's write projections (``GlobalBankParams``' tree)."""

    rng: R.BlockRng
    bankp: Params


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for k in ROUTES:
        ROUTES[k] = 0


# ---------------------------------------------------------------------------
# plain versions (the CPU path and the kernels' reference on the card);
# in training they take the masks the kernels draw (fused_ref's hash) and
# return the bank-write partials
# ---------------------------------------------------------------------------

def _masks(train: Optional[UnitTrain], b: int, g: FusedGeom, device,
           *keys: str):
    if train is None:
        return (None,) * len(keys)
    m = R.hash_block_masks(train.rng, b, g, device, keys)
    return tuple(m[k] for k in keys)


def swa_plain(p: Params, x, bank_k, bank_v, g: FusedGeom, dtype,
              train: Optional[UnitTrain] = None):
    """(out, xn), and in training (out, xn, part_k, part_v)."""
    xn = R.layer_norm(x, p["norm1"], dtype)
    out, normed = R.swa_ref(p["swa"], xn, bank_k, bank_v, g, dtype,
                            _masks(train, x.shape[0], g, x.device,
                                   "swa_attn", "swa_proj"))
    if train is None:
        return out, xn
    return (out, xn) + R.bank_write_partial(train.bankp, normed)


def msda_plain(p: Params, xn, bank_k, bank_v, g: FusedGeom, dtype,
               train: Optional[UnitTrain] = None):
    """out, and in training (out, part_k, part_v)."""
    out, normed = R.msda_ref(p["msda"], xn, bank_k, bank_v, g, dtype,
                             _masks(train, xn.shape[0], g, xn.device,
                                    "msda_attn", "msda_proj"))
    if train is None:
        return out
    return (out,) + R.bank_write_partial(train.bankp, normed)


def cga_plain(p: Params, xn, bank_k, bank_v, g: FusedGeom, dtype,
              train: Optional[UnitTrain] = None):
    """out, and in training (out, part_k, part_v)."""
    out, normed = R.cga_ref(p["cga"], xn, bank_k, bank_v, g, dtype,
                            _masks(train, xn.shape[0], g, xn.device,
                                   "cga_attn", "cga_proj"))
    if train is None:
        return out
    return (out,) + R.bank_write_partial(train.bankp, normed)


def cross_tail_plain(p: Params, x, xn, out_swa, out_msda, out_cga, bank_k,
                     bank_v, g: FusedGeom, dtype,
                     train: Optional[UnitTrain] = None):
    b = x.shape[0]
    out_cross = R.cross_ref(p["cross_attn"], xn, bank_k, bank_v, g, dtype,
                            _masks(train, b, g, x.device, "cross_attn",
                                   "cross_proj"))
    return R.tail_ref(p, x, (out_swa, out_msda, out_cga, out_cross), g,
                      dtype, _masks(train, b, g, x.device, "bn1", "bn2",
                                    "dp1", "ffn", "dp2"))


PLAIN = {"unit_swa": swa_plain, "unit_msda": msda_plain,
         "unit_cga": cga_plain, "unit_cross_tail": cross_tail_plain}


# ---------------------------------------------------------------------------
# C interface (mirrors csrc/common.cuh)
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_DIM_FIELDS = ("B", "n", "side", "nw", "c", "heads", "lin_k", "bank_s",
               "msda_keep", "msda_pad", "groups", "cperg", "ccf_hidden",
               "bottleneck_hidden", "d_c", "guard", "stab_ccf", "stab_dw",
               "dw_bias", "grid", "train", "drop_on", "rgrid")


class Dims(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_int) for n in _DIM_FIELDS]
                + [("thr", ctypes.c_uint), ("keep", ctypes.c_float),
                   ("dp_thr", ctypes.c_uint), ("dp_scale", ctypes.c_float),
                   ("salt", ctypes.c_uint * len(R.MASK_KEYS))])


def _ptrs(names: str):
    return [(n, _P) for n in names.split()]


class BankWrite(ctypes.Structure):
    _fields_ = _ptrs("norm_s norm_b comp_w comp_b gate_w gate_b branch_s "
                     "branch_b part part_out")


class SwaArgs(ctypes.Structure):
    _fields_ = _ptrs("x out xn norm1_s norm1_b qkv_w qkv_b e_k e_v bank_k "
                     "bank_v proj_w proj_b ws") + [("bw", BankWrite),
                                                   ("d", Dims)]


class MsdaArgs(ctypes.Structure):
    _fields_ = _ptrs("xn out sel_t qkv_w qkv_b e_k e_v bank_k bank_v proj_w "
                     "proj_b ws") + [("bw", BankWrite), ("d", Dims)]


class CgaArgs(ctypes.Structure):
    _fields_ = _ptrs("xn out q_w q_b k_w k_b v_w v_b bk_w bk_b bv_w bv_b "
                     "bank_k bank_v proj_w proj_b ws") + [("bw", BankWrite),
                                                         ("d", Dims)]


class CrossTailArgs(ctypes.Structure):
    _fields_ = (_ptrs("x xn swa msda cga y cq_w cq_b ck_w ck_b cv_w cv_b "
                      "cp_w cp_b bank_k bank_v")
                + [(n, _P * 4) for n in ("norm_s", "norm_b", "comp_w",
                                         "comp_b")]
                + _ptrs("fusion bn1_w bn1_b bn2_w bn2_b norm2_s norm2_b "
                        "fc1_w fc1_b dwn_s dwn_b dw_w dw_b dw_scale pdn_s "
                        "pdn_b fc2_w fc2_b gamma ws")
                + [("d", Dims)])


class BwdCommon(ctypes.Structure):
    _fields_ = _ptrs("bank_kr bank_vr flag gws grad") + [
        ("wstride", ctypes.c_int), ("scratch", _P)]


# gradient fields of each backward kernel and the parameter each belongs
# to (a path in the block's tree; "bank_k" / "bank_v" are the bank rows)
_BRANCHES = ("swa", "msda", "cga", "cross")
GRADS: Dict[str, List[Tuple[str, Tuple[str, ...]]]] = {
    "unit_swa": [
        ("norm1_s", ("norm1", "scale")), ("norm1_b", ("norm1", "bias")),
        ("qkv_w", ("swa", "qkv", "kernel")), ("qkv_b", ("swa", "qkv", "bias")),
        ("e_k", ("swa", "linformer", "E_k")),
        ("e_v", ("swa", "linformer", "E_v")),
        ("proj_w", ("swa", "proj", "kernel")),
        ("proj_b", ("swa", "proj", "bias"))],
    "unit_msda": [
        ("qkv_w", ("msda", "qkv_kernel")), ("qkv_b", ("msda", "qkv_bias")),
        ("e_k", ("msda", "linformer", "E_k")),
        ("e_v", ("msda", "linformer", "E_v")),
        ("proj_w", ("msda", "proj", "kernel")),
        ("proj_b", ("msda", "proj", "bias"))],
    "unit_cga": [
        (f"{f}_{s}", ("cga", m, k))
        for f, m in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                     ("bk", "bank_k_proj"), ("bv", "bank_v_proj"),
                     ("proj", "proj"))
        for s, k in (("w", "kernel"), ("b", "bias"))],
    "unit_cross_tail": (
        [(f"c{f}_{s}", ("cross_attn", m, k))
         for f, m in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                      ("p", "proj"))
         for s, k in (("w", "kernel"), ("b", "bias"))]
        + [(f"norm_{s}.{i}", (f"norm_{n}", k))
           for i, n in enumerate(_BRANCHES)
           for s, k in (("s", "scale"), ("b", "bias"))]
        + [(f"comp_{s}.{i}", (f"compress_{n}", k))
           for i, n in enumerate(_BRANCHES)
           for s, k in (("w", "kernel"), ("b", "bias"))]
        + [("fusion", ("fusion", "fusion_weights")),
           ("bn1_w", ("bottleneck_mlp", "fc1", "kernel")),
           ("bn1_b", ("bottleneck_mlp", "fc1", "bias")),
           ("bn2_w", ("bottleneck_mlp", "fc2", "kernel")),
           ("bn2_b", ("bottleneck_mlp", "fc2", "bias")),
           ("norm2_s", ("norm2", "scale")), ("norm2_b", ("norm2", "bias")),
           ("fc1_w", ("ccf_ffn", "fc1", "kernel")),
           ("fc1_b", ("ccf_ffn", "fc1", "bias")),
           ("dwn_s", ("ccf_ffn", "dwconv_norm", "scale")),
           ("dwn_b", ("ccf_ffn", "dwconv_norm", "bias")),
           ("dw_w", ("ccf_ffn", "dwconv", "dwconv", "weight")),
           ("dw_b", ("ccf_ffn", "dwconv", "dwconv", "bias")),
           ("dw_scale", ("ccf_ffn", "dwconv", "scale")),
           ("pdn_s", ("ccf_ffn", "post_dwconv_norm", "scale")),
           ("pdn_b", ("ccf_ffn", "post_dwconv_norm", "bias")),
           ("fc2_w", ("ccf_ffn", "fc2", "kernel")),
           ("fc2_b", ("ccf_ffn", "fc2", "bias")),
           ("gamma", ("ccf_ffn", "gamma"))]),
}


def _grad_struct(unit: str):
    """The C struct of a backward kernel's gradient pointers: the fields
    of GRADS in order (``name.i`` entries as arrays of 4), with the bank
    rows last, or after the cross branch's eight for cross_tail."""
    fields = []
    for name, _ in GRADS[unit]:
        base, _, idx = name.partition(".")
        if not idx:
            fields.append((base, _P))
        elif idx == "0":
            fields.append((base, _P * 4))
    at = 8 if unit == "unit_cross_tail" else len(fields)
    fields[at:at] = _ptrs("bank_k bank_v")
    return type(f"{unit}_grads", (ctypes.Structure,), {"_fields_": fields})


_GRAD_STRUCT = {u: _grad_struct(u) for u in UNITS}


class SwaBwdArgs(ctypes.Structure):
    _fields_ = [("f", SwaArgs), ("c", BwdCommon)] + _ptrs(
        "d_out d_xn d_x") + [("g", _GRAD_STRUCT["unit_swa"])]


class MsdaBwdArgs(ctypes.Structure):
    _fields_ = [("f", MsdaArgs), ("c", BwdCommon)] + _ptrs(
        "d_out d_xn") + [("g", _GRAD_STRUCT["unit_msda"])]


class CgaBwdArgs(ctypes.Structure):
    _fields_ = [("f", CgaArgs), ("c", BwdCommon)] + _ptrs(
        "d_out d_xn") + [("g", _GRAD_STRUCT["unit_cga"])]


class CrossTailBwdArgs(ctypes.Structure):
    _fields_ = [("f", CrossTailArgs), ("c", BwdCommon)] + _ptrs(
        "d_y d_x d_xn d_swa d_msda d_cga") + [
            ("g", _GRAD_STRUCT["unit_cross_tail"])]


_STRUCTS = (Dims, SwaArgs, MsdaArgs, CgaArgs, CrossTailArgs, SwaBwdArgs,
            MsdaBwdArgs, CgaBwdArgs, CrossTailBwdArgs)
_ENTRY = {"unit_swa": SwaArgs, "unit_msda": MsdaArgs, "unit_cga": CgaArgs,
          "unit_cross_tail": CrossTailArgs, "unit_swa_bwd": SwaBwdArgs,
          "unit_msda_bwd": MsdaBwdArgs, "unit_cga_bwd": CgaBwdArgs,
          "unit_cross_tail_bwd": CrossTailBwdArgs}
# the bf16 tensor-core forward entries take
# qv_{entry}(args, bf16 weight, bf16 weight, is_bf16, stream), the
# backward ones qv_{entry}(args, bf16 weights, is_bf16, stream)
_BOUND: Dict[int, bool] = {}
SMEM_LIMIT = 232448          # bytes of shared memory a block may opt in to


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points' types (the units' and the flash
    kernel's) and check the struct layouts."""
    if _BOUND.get(id(lib)):
        return lib
    lib.qv_struct_size.argtypes = [ctypes.c_int]
    lib.qv_struct_size.restype = ctypes.c_int
    for i, st in enumerate(_STRUCTS):
        got = lib.qv_struct_size(i)
        if got != ctypes.sizeof(st):
            raise RuntimeError(f"{st.__name__}: C size {got} != ctypes size "
                               f"{ctypes.sizeof(st)}")
    for name, st in _ENTRY.items():
        fn = getattr(lib, f"qv_{name}")
        fn.argtypes = [ctypes.POINTER(st), ctypes.c_int, _P]
        fn.restype = ctypes.c_int
        smem = getattr(lib, f"qv_{name}_smem")
        smem.argtypes = [ctypes.POINTER(Dims)]
        smem.restype = ctypes.c_int
    for name in _MMA_FWD:         # the bf16 tensor-core forwards
        unit = name[:name.index("_mma")]
        fn = getattr(lib, f"qv_{name}")
        fn.argtypes = [ctypes.POINTER(_ENTRY[unit]), _P, _P, ctypes.c_int, _P]
        fn.restype = ctypes.c_int
        smem = getattr(lib, f"qv_{name}_smem")
        smem.argtypes = [ctypes.POINTER(Dims)]
        smem.restype = ctypes.c_int
    for name in _MMA_BWD:         # the bf16 tensor-core backwards
        unit = name[:name.index("_mma")]
        fn = getattr(lib, f"qv_{name}")
        fn.argtypes = [ctypes.POINTER(_ENTRY[unit]), _P, ctypes.c_int, _P]
        fn.restype = ctypes.c_int
        smem = getattr(lib, f"qv_{name}_smem")
        smem.argtypes = [ctypes.POINTER(Dims)]
        smem.restype = ctypes.c_int
    for name in _MMA_FWD256:      # + scratch: (args, w, w, scratch, ..)
        unit = name[:name.index("_mma")]
        fn = getattr(lib, f"qv_{name}")
        fn.argtypes = [ctypes.POINTER(_ENTRY[unit]), _P, _P, _P,
                       ctypes.c_int, _P]
        fn.restype = ctypes.c_int
    for name in _MMA_BWD256:      # (args, w, scratch, is_bf16, stream)
        unit = name[:name.index("_mma")]
        fn = getattr(lib, f"qv_{name}")
        fn.argtypes = [ctypes.POINTER(_ENTRY[unit]), _P, _P, ctypes.c_int,
                       _P]
        fn.restype = ctypes.c_int
    for name in _MMA_FWD256 + _MMA_BWD256:
        smem = getattr(lib, f"qv_{name}_smem")
        smem.argtypes = [ctypes.POINTER(Dims)]
        smem.restype = ctypes.c_int
    for name in (("unit_cross_tail_bwd",) + _MMA_BWD + _MMA_FWD256
                 + _MMA_BWD256):  # scratch floats (per block, or per call)
        fn = getattr(lib, f"qv_{name}_scratch")
        fn.argtypes = [ctypes.POINTER(Dims)]
        fn.restype = ctypes.c_int
    for name in CLUSTERS:         # (CTAs per SM, clusters) on the card
        fn = getattr(lib, f"qv_{name}_occupancy")
        fn.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
        fn.restype = ctypes.c_int
    # the flash-attention kernel and the tensor-core self-test are built
    # into the same library
    from qavit_tpu_torch.kernels import flash_attention, mma_selftest
    flash_attention.bind(lib)
    mma_selftest.bind(lib)
    _BOUND[id(lib)] = True
    return lib


# token geometries the kernels take: (tokens, SWA windows) -> the most
# pooled MSDA rows.  n = 16 in one window (hqavit_c100), n = 64 in four
# 16-token windows (hqavit_tiny_in) and n = 256 in sixteen
# (qavit_v2_extreme_tin), in eval and in training (n = 64 in training and
# n = 256: bf16 only, kernel_geometry_error with the dtype)
EVAL_GEOMETRIES = {(16, 1): 16, (64, 4): 40, (256, 16): 128}
TRAIN_GEOMETRIES = {(16, 1): 16, (64, 4): 40, (256, 16): 128}


def kernel_geometry_error(g: FusedGeom, train: bool = False,
                          dtype=None) -> Optional[str]:
    """Why the kernels cannot run geometry ``g`` (None if they can); with
    ``train``, in train mode and for the backward kernels, and with
    ``dtype``, in that working dtype (float32 trains at n=16 only)."""
    cpg = g.c // g.groups
    table = TRAIN_GEOMETRIES if train else EVAL_GEOMETRIES
    keep = table.get((g.n, g.nw))
    if keep is None or g.ws2 != 16:
        mode = "in train mode and for the backward kernels" if train \
            else "in eval"
        shapes = " or ".join(f"{n} tokens in {w} SWA window(s) of 16"
                             for n, w in table)
        return (f"the CUDA units take {shapes} {mode} (ROADMAP queue 2 item "
                f"2c); got n={g.n} in {g.nw} window(s) of {g.ws2}")
    if g.n == 256 and dtype == torch.float32:
        return ("the CUDA units run n=256 in bf16 only (tensor-core "
                "kernels); float32 at n=256 is not ported (ROADMAP queue 2 "
                "item 2d): run in bf16, the default")
    if train and g.n != 16 and dtype == torch.float32:
        return ("the CUDA units train at n=64 in bf16 only (tensor-core "
                "kernels); float32 at n=64 in training is not ported "
                "(ROADMAP queue 2 item 2d): train in bf16, the default")
    checks = (
        (g.bank_s <= 16, "at most 16 bank rows"),
        (g.msda_keep <= keep, f"at most {keep} pooled MSDA rows at n={g.n}"),
        (all(v % 4 == 0 for v in (g.c, cpg, g.groups * g.cperg,
                                  g.ccf_hidden, g.bottleneck_hidden)),
         "widths that are multiples of 4"),
        (4 * g.d_c == g.c, "compress_ratio 4"),
        (g.c % g.heads == 0 and g.cperg % g.heads == 0, "whole head widths"),
    )
    for ok, need in checks:
        if not ok:
            return f"the CUDA units need {need}; got {g}"
    return None


def msda_mma_error(g: FusedGeom) -> Optional[str]:
    """Why the bf16 MSDA kernels (``msda_mma_kernel`` at n=64, written for
    hqavit_tiny_in's widths; ``msda_mma16_kernel`` at n=16, for
    hqavit_c100's, four samples of 16 pooled rows at most to a tile)
    cannot run geometry ``g`` (None if they can), in eval and in
    training; at n=256 the unit's kernel sequence of
    ``csrc/unit_msda256.cu``."""
    checks = (
        ((g.n, g.nw) in ((64, 4), (16, 1), (256, 16)),
         "n=64 in four SWA windows, n=16 in one or n=256 in sixteen"),
        ((g.c, g.heads, g.lin_k) == (192, 4, 32),
         "C=192, 4 heads of 48 and linformer_k=32"),
        (g.bank_s <= 16, "at most 16 bank rows"),
        (g.msda_keep <= {64: 48, 256: 128}.get(g.n, 16),
         "at most 48 pooled rows at n=64, 128 at n=256 and 16 at n=16"),
        (g.pool_stride <= 8, "a landmark pooling stride of at most 8"),
    )
    for ok, need in checks:
        if not ok:
            return f"the bf16 MSDA kernel needs {need}; got {g}"
    return None


def swa_mma_error(g: FusedGeom) -> Optional[str]:
    """Why the bf16 SWA kernel (``swa_mma_kernel``, written for
    hqavit_tiny_in's and hqavit_c100's widths) cannot run geometry ``g``
    (None if it can), in eval and in training."""
    checks = (
        ((g.n, g.nw, g.ws2) in ((64, 4, 16), (16, 1, 16), (256, 16, 16)),
         "n=64 on an 8x8 grid in four 4x4 windows, n=256 on a 16x16 grid "
         "in sixteen, or n=16 in one"),
        ((g.c, g.heads, g.lin_k) == (192, 4, 32),
         "C=192, 4 heads of 48 and linformer_k=32"),
        (g.bank_s <= 16, "at most 16 bank rows"),
    )
    for ok, need in checks:
        if not ok:
            return f"the bf16 SWA kernel needs {need}; got {g}"
    return None


def cga_mma_error(g: FusedGeom) -> Optional[str]:
    """Why the bf16 CGA kernel (``cga_mma_kernel``, written for
    hqavit_c100's and hqavit_tiny_in's widths) cannot run geometry ``g``
    (None if it can), n=16 in one SWA window or n=64 in four, in eval and
    in training."""
    checks = (
        ((g.n, g.nw) in ((16, 1), (64, 4), (256, 16)),
         "n=16 in one SWA window, n=64 in four or n=256 in sixteen"),
        ((g.c, g.groups, g.cperg, g.heads) == (192, 6, 16, 4),
         "C=192 in 6 channel groups of 32, cperg 16 and 4 heads"),
        (g.bank_s <= 16, "at most 16 bank rows"),
    )
    for ok, need in checks:
        if not ok:
            return f"the bf16 CGA kernel needs {need}; got {g}"
    return None


def cross_tail_mma_error(g: FusedGeom) -> Optional[str]:
    """Why the bf16 cross/tail kernel (``cross_tail_mma_kernel``, written
    for hqavit_tiny_in's and hqavit_c100's widths) cannot run geometry
    ``g`` (None if it can), in eval and in training."""
    checks = (
        (g.n in (16, 64, 256),
         "n=16 on a 4x4 grid, n=64 on an 8x8 or n=256 on a 16x16 grid"),
        ((g.c, g.heads) == (192, 4), "C=192 and 4 heads of 48"),
        ((g.ccf_hidden, g.bottleneck_hidden, g.d_c) == (96, 96, 48),
         "CCF-FFN and bottleneck hidden widths of 96 and d_c=48"),
        (g.bank_s <= 16, "at most 16 bank rows"),
        (g.stabilized_ccfffn and g.stabilized_dwconv,
         "stabilized_ccfffn and stabilized_dwconv"),
    )
    for ok, need in checks:
        if not ok:
            return f"the bf16 cross/tail kernel needs {need}; got {g}"
    return None


def swa_bwd_mma_error(g: FusedGeom) -> Optional[str]:
    """Why the bf16 SWA backward kernel (``swa_bwd_mma_kernel``, written
    for hqavit_c100's and hqavit_tiny_in's widths) cannot run geometry
    ``g`` (None if it can)."""
    checks = (
        ((g.n, g.nw, g.ws2) in ((16, 1, 16), (64, 4, 16), (256, 16, 16)),
         "n=16 in one SWA window, n=64 on an 8x8 grid in four or n=256 on "
         "a 16x16 grid in sixteen"),
        ((g.c, g.heads, g.lin_k) == (192, 4, 32),
         "C=192, 4 heads of 48 and linformer_k=32"),
        (g.bank_s <= 16, "at most 16 bank rows"),
    )
    for ok, need in checks:
        if not ok:
            return f"the bf16 SWA backward kernel needs {need}; got {g}"
    return None


def msda_bwd_mma_error(g: FusedGeom) -> Optional[str]:
    """Why the bf16 MSDA backward kernels (``msda_bwd_mma_kernel`` at
    n=16, ``msda_bwd_mma64_kernel`` at n=64, written for hqavit_c100's and
    hqavit_tiny_in's widths) cannot run geometry ``g`` (None if they
    can)."""
    checks = (
        ((g.n, g.nw) in ((16, 1), (64, 4), (256, 16)),
         "n=16 in one SWA window, n=64 in four or n=256 in sixteen"),
        ((g.c, g.heads, g.lin_k) == (192, 4, 32),
         "C=192, 4 heads of 48 and linformer_k=32"),
        (g.msda_keep <= {16: 16, 64: 48, 256: 128}.get(g.n, 0),
         "at most 16 pooled rows at n=16, 48 at n=64 and 128 at n=256"),
        (g.bank_s <= 16, "at most 16 bank rows"),
    )
    for ok, need in checks:
        if not ok:
            return f"the bf16 MSDA backward kernel needs {need}; got {g}"
    return None


def cross_tail_bwd_mma_error(g: FusedGeom) -> Optional[str]:
    """Why the bf16 cross/tail backward kernel
    (``cross_tail_bwd_mma_kernel``, written for hqavit_c100's and
    hqavit_tiny_in's widths) cannot run geometry ``g`` (None if it
    can)."""
    checks = (
        (g.n in (16, 64, 256),
         "n=16 on a 4x4 grid, n=64 on an 8x8 or n=256 on a 16x16 grid"),
        ((g.c, g.heads) == (192, 4), "C=192 and 4 heads of 48"),
        ((g.ccf_hidden, g.bottleneck_hidden, g.d_c) == (96, 96, 48),
         "CCF-FFN and bottleneck hidden widths of 96 and d_c=48"),
        (g.bank_s <= 16, "at most 16 bank rows"),
        (g.stabilized_ccfffn and g.stabilized_dwconv,
         "stabilized_ccfffn and stabilized_dwconv"),
    )
    for ok, need in checks:
        if not ok:
            return (f"the bf16 cross/tail backward kernel needs {need}; "
                    f"got {g}")
    return None


def cga_bwd_mma_error(g: FusedGeom) -> Optional[str]:
    """Why the bf16 CGA backward kernel (``cga_bwd_mma_kernel``, written
    for hqavit_c100's and hqavit_tiny_in's widths) cannot run geometry
    ``g`` (None if it can)."""
    checks = (
        ((g.n, g.nw) in ((16, 1), (64, 4), (256, 16)),
         "n=16 in one SWA window, n=64 in four or n=256 in sixteen"),
        ((g.c, g.groups, g.cperg, g.heads) == (192, 6, 16, 4),
         "C=192 in 6 channel groups of 32, cperg 16 and 4 heads"),
        (g.bank_s <= 16, "at most 16 bank rows"),
    )
    for ok, need in checks:
        if not ok:
            return f"the bf16 CGA backward kernel needs {need}; got {g}"
    return None


_BWD_MMA_ERROR = {"unit_swa": swa_bwd_mma_error,
                  "unit_msda": msda_bwd_mma_error,
                  "unit_cga": cga_bwd_mma_error,
                  "unit_cross_tail": cross_tail_bwd_mma_error}


def bwd_entry(unit: str, g: FusedGeom, dtype) -> str:
    """The C entry (``qv_{entry}``) a backward launch of ``unit`` takes:
    at n=16 the tensor-core kernel in bf16 at the widths it is written
    for, else the unit's CUDA-core kernel; at n=64 the n=64 tensor-core
    kernel, or ValueError with the reason (float32, other widths).  A
    route chosen by dtype and widths before the launch, never a retry."""
    err = _BWD_MMA_ERROR[unit](g)
    if g.n == 16:
        if dtype == torch.bfloat16 and err is None:
            return f"{unit}_bwd_mma"
        return f"{unit}_bwd"
    err = kernel_geometry_error(g, True, dtype) or err
    if err is not None:
        raise ValueError(f"{unit}_bwd: {err}")
    return f"{unit}_bwd_mma256" if g.n == 256 else f"{unit}_bwd_mma64"


def _dims(g: FusedGeom, b: int, p: Params, grid: int, rgrid: int,
          rng: Optional[R.BlockRng]) -> Dims:
    dw = p["ccf_ffn"]["dwconv"]
    d = Dims(B=b, n=g.n, side=math.isqrt(g.n), nw=g.nw, c=g.c,
             heads=g.heads, lin_k=g.lin_k, bank_s=g.bank_s,
             msda_keep=g.msda_keep, groups=g.groups, cperg=g.cperg,
             ccf_hidden=g.ccf_hidden,
             bottleneck_hidden=g.bottleneck_hidden, d_c=g.d_c,
             guard=int(g.guard_nans), stab_ccf=int(g.stabilized_ccfffn),
             stab_dw=int(g.stabilized_dwconv),
             dw_bias=int("bias" in dw["dwconv"]), grid=grid, rgrid=rgrid,
             keep=1.0, dp_scale=1.0)
    if rng is not None:
        d.train = 1
        d.drop_on = int(rng.rate > 0.0)
        d.thr = R.threshold(rng.rate)
        d.keep = R.keep_f32(rng.rate)
        d.dp_thr = R.threshold(rng.dpr)
        d.dp_scale = float(np.float32(1.0) / (np.float32(1.0)
                                               - np.float32(rng.dpr)))
        for i, s in enumerate(rng.salts):
            d.salt[i] = s
    return d


_SM_COUNT: Dict[str, int] = {}


def _sm_count(device: torch.device) -> int:
    key = str(device)
    if key not in _SM_COUNT:
        _SM_COUNT[key] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SM_COUNT[key]


def train_grid(device: torch.device, b: int) -> "Grid":
    """The blocks of a train-mode unit or backward kernel and of its
    reduction pass on ``device``: one block per SM, as the units' shared
    memory allows."""
    sms = _sm_count(device)
    return Grid(min(b, sms), 4 * sms)


# the n=64 backward entries that run on clusters of two CTAs: the CTAs
# resident per SM (shared memory and registers allow)
CLUSTER_BWD = {"unit_swa_bwd_mma64": 1, "unit_msda_bwd_mma64": 1,
               "unit_cross_tail_bwd_mma64": 1, "unit_cga_bwd_mma64": 2,
               "unit_swa_bwd_mma256": 1}
# the n=64 train-mode forward entries that do, a sample a cluster
CLUSTER_FWD = {"unit_swa_mma_train64": 2, "unit_msda_mma_train64": 2,
               "unit_cross_tail_mma_train64": 2}
CLUSTERS = {**CLUSTER_BWD, **CLUSTER_FWD}


def cluster_grid(entry: str, grid: "Grid", b: int,
                 device: Optional[torch.device] = None) -> "Grid":
    """The launch of C entry ``entry`` (a backward, or an n=64 train-mode
    forward) given the train grid ``grid`` (``grid.blocks``: one block a
    sample, at most one an SM): for a two-CTA-cluster entry
    (:data:`CLUSTERS`), as many clusters as the SMs hold at once, at most
    one a work item (a sample; SWA's a window), each with its own slice.
    The SMs are ``grid.blocks``, times SWA's windows a sample (four at
    n=64, sixteen at n=256) on ``device``'s card, at most its SMs (so at
    B=128 SWA's 512 windows fill 132 SMs); any other entry keeps
    ``grid``."""
    per_sm = CLUSTERS.get(entry)
    if per_sm is None:
        return grid
    per_sample = {"unit_swa_bwd_mma64": 4,        # SWA: windows
                  "unit_swa_bwd_mma256": 16}.get(entry, 1)
    sms = grid.blocks
    if device is not None and device.type == "cuda":
        sms = min(grid.blocks * per_sample, _sm_count(device))
    return Grid(max(1, min(b * per_sample, sms * per_sm // 2)), grid.reduce)


class _Launch:
    """Argument checks and pointer collection for one launch."""

    def __init__(self, lib, name: str, g: FusedGeom, dtype, lead,
                 train: bool = False):
        if dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"{name}: working dtype must be float32 or "
                            f"bfloat16, got {dtype}")
        err = kernel_geometry_error(g, train, dtype)
        if err is not None:
            raise ValueError(f"{name}: {err}")
        self.lib, self.name, self.g, self.dtype = lib, name, g, dtype
        self.device = lead.device
        self.b = lead.shape[0]
        self.held: List[torch.Tensor] = []   # workspaces the kernel uses

    def act(self, t: torch.Tensor) -> int:
        """An activation [B, n, C] in the working dtype."""
        want = (self.b, self.g.n, self.g.c)
        if (t.device != self.device or t.dtype != self.dtype
                or tuple(t.shape) != want or not t.is_contiguous()):
            raise ValueError(f"{self.name}: activation must be a contiguous "
                             f"{self.dtype} {want} on {self.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        return t.data_ptr()

    def w(self, t: torch.Tensor, *shape: int) -> int:
        """A float32 parameter of the given shape."""
        if (t.device != self.device or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{self.name}: parameter must be a contiguous "
                             f"float32 {shape} on {self.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        return t.data_ptr()

    def dense(self, p: Params, k: int, n: int) -> Tuple[int, int]:
        return self.w(p["kernel"], k, n), self.w(p["bias"], n)

    def ln(self, p: Params, n: int) -> Tuple[int, int]:
        return self.w(p["scale"], n), self.w(p["bias"], n)

    def run(self, args, d: Dims, stream: Optional[int],
            entry: Optional[str] = None, extra=()) -> torch.Tensor:
        """Launch with dims ``d`` through C entry ``qv_{entry}`` (the
        unit's own by default), ``extra`` pointers after the arguments;
        returns the kernel's guard workspace ([blocks done, NaN seen],
        the flag the backward reads)."""
        entry = entry or self.name
        args.d = d
        smem = getattr(self.lib, f"qv_{entry}_smem")(ctypes.byref(d))
        if smem > SMEM_LIMIT:
            raise ValueError(f"{self.name}: needs {smem} B of shared memory "
                             f"> {SMEM_LIMIT}")
        ws = torch.zeros(2, dtype=torch.int32, device=self.device)
        args.ws = ws.data_ptr()
        self.held.append(ws)
        rc = getattr(self.lib, f"qv_{entry}")(
            ctypes.byref(args), *extra, int(self.dtype == torch.bfloat16),
            stream)
        if rc != 0:
            raise RuntimeError(f"{self.name}: kernel launch failed with CUDA "
                               f"error {rc}")
        ROUTES[entry] += 1
        return ws


def _bank(lc: _Launch, bank_k, bank_v) -> Tuple[int, int]:
    s, c = lc.g.bank_s, lc.g.c
    return lc.w(bank_k, 1, s, c), lc.w(bank_v, 1, s, c)


_SEL_T: Dict[Tuple, torch.Tensor] = {}


def _msda_sel_t(g: FusedGeom, device) -> torch.Tensor:
    """The MSDA pooling matrix, transposed to [n, msda_keep], on device."""
    key = (g.n, g.msda_keep, g.pool_stride, g.msda_idx, str(device))
    if key not in _SEL_T:
        sel = R.msda_mix_matrix(g)
        _SEL_T[key] = torch.from_numpy(sel.T.copy()).to(device)
    return _SEL_T[key]


class Grid(NamedTuple):
    """Blocks of a train-mode launch and of its reduction pass."""

    blocks: int
    reduce: int


def _bank_write(lc: _Launch, a, p: Params, branch: str,
                train: UnitTrain, grid: Grid) -> torch.Tensor:
    """Point ``a.bw`` at the write projections and a zeroed per-block
    partial workspace; returns the [2, S, C] sum the reduction writes."""
    c, s, bp = lc.g.c, lc.g.bank_s, train.bankp
    bw = a.bw
    bw.norm_s, bw.norm_b = lc.w(bp["write_norm_scale"], c), lc.w(
        bp["write_norm_bias"], c)
    bw.comp_w = lc.w(bp["write_compression_kernel"], c, c)
    bw.comp_b = lc.w(bp["write_compression_bias"], c)
    bw.gate_w = lc.w(bp["write_gate_kernel"], c, s)
    bw.gate_b = lc.w(bp["write_gate_bias"], s)
    bw.branch_s, bw.branch_b = lc.ln(p[branch]["norm"], c)
    part = torch.empty(grid.blocks, 2, s, c, device=lc.device)
    out = torch.empty(2, s, c, device=lc.device)
    bw.part, bw.part_out = part.data_ptr(), out.data_ptr()
    lc.held.append(part)
    return out


def _fwd_dims(lc: _Launch, p: Params, train: Optional[UnitTrain],
              grid: Optional[Grid]) -> Dims:
    if train is None:     # eval: one block per sample
        return _dims(lc.g, lc.b, p, lc.b, 1, None)
    return _dims(lc.g, lc.b, p, grid.blocks, grid.reduce, train.rng)


# ---------------------------------------------------------------------------
# forward launches (lib: a loaded kernel library, stream: a cudaStream_t or
# None).  Every workspace a launch allocates is held by its _Launch until
# the launch function returns, after the kernel was enqueued; from then
# on PyTorch's caching allocator hands the memory only to later work on
# the same stream.  Eval returns the outputs; training (train and grid
# given) also returns the bank partials [2, S, C] (not for cross_tail) and
# the guard workspace the backward reads.
# ---------------------------------------------------------------------------

def launch_swa(lib, p: Params, x, bank_k, bank_v, g: FusedGeom, dtype,
               stream=None, train: Optional[UnitTrain] = None,
               grid: Optional[Grid] = None, keep_ws: bool = False):
    lc = _Launch(lib, "unit_swa", g, dtype, x, train is not None)
    c, ps = g.c, p["swa"]
    out, xn = torch.empty_like(x), torch.empty_like(x)
    a = SwaArgs()
    a.x, a.out, a.xn = lc.act(x), lc.act(out), lc.act(xn)
    a.norm1_s, a.norm1_b = lc.ln(p["norm1"], c)
    a.qkv_w, a.qkv_b = lc.dense(ps["qkv"], c, 3 * c)
    a.e_k = lc.w(ps["linformer"]["E_k"], g.ws2, g.lin_k)
    a.e_v = lc.w(ps["linformer"]["E_v"], g.ws2, g.lin_k)
    a.bank_k, a.bank_v = _bank(lc, bank_k, bank_v)
    a.proj_w, a.proj_b = lc.dense(ps["proj"], c, c)
    route = swa_route(g, dtype, train is not None)
    if route != "unit_swa":
        ws, part = _run_mma(lc, a, p, stream, swa_mma_error,
                            ps["qkv"]["kernel"], ps["proj"]["kernel"],
                            train=train, grid=grid, branch="swa",
                            entry=route)
        if train is None:
            return (out, xn, ws) if keep_ws else (out, xn)
        return out, xn, part, ws
    if train is None:     # eval: one block per (sample, window)
        ws = lc.run(a, _dims(g, lc.b, p, lc.b * g.nw, 1, None), stream)
        return (out, xn, ws) if keep_ws else (out, xn)
    part = _bank_write(lc, a, p, "swa", train, grid)
    ws = lc.run(a, _fwd_dims(lc, p, train, grid), stream)
    return out, xn, part, ws


def launch_msda(lib, p: Params, xn, bank_k, bank_v, g: FusedGeom, dtype,
                stream=None, train: Optional[UnitTrain] = None,
                grid: Optional[Grid] = None, keep_ws: bool = False):
    lc = _Launch(lib, "unit_msda", g, dtype, xn, train is not None)
    c, pm = g.c, p["msda"]
    out = torch.empty_like(xn)
    sel_t = _msda_sel_t(g, xn.device)
    pad = pm["linformer"]["E_k"].shape[0]
    a = MsdaArgs()
    a.xn, a.out = lc.act(xn), lc.act(out)
    a.sel_t = lc.w(sel_t, g.n, g.msda_keep)
    a.qkv_w, a.qkv_b = lc.w(pm["qkv_kernel"], c, 3 * c), lc.w(
        pm["qkv_bias"], 3 * c)
    a.e_k = lc.w(pm["linformer"]["E_k"], pad, g.lin_k)
    a.e_v = lc.w(pm["linformer"]["E_v"], pad, g.lin_k)
    a.bank_k, a.bank_v = _bank(lc, bank_k, bank_v)
    a.proj_w, a.proj_b = lc.dense(pm["proj"], c, c)
    route = msda_route(g, dtype, train is not None)
    if route != "unit_msda":
        ws, part = _run_mma(lc, a, p, stream, msda_mma_error,
                            pm["qkv_kernel"], pm["proj"]["kernel"],
                            train=train, grid=grid, branch="msda",
                            entry=route)
        if train is None:
            return _eval_out(out, ws, keep_ws)
        return out, part, ws
    if train is None:
        ws = lc.run(a, _fwd_dims(lc, p, None, None), stream)
        return _eval_out(out, ws, keep_ws)
    part = _bank_write(lc, a, p, "msda", train, grid)
    ws = lc.run(a, _fwd_dims(lc, p, train, grid), stream)
    return out, part, ws


def _eval_out(out, ws, keep_ws: bool):
    """An eval launch's result: its output, and with ``keep_ws`` its
    guard workspace too (the flag the eval-mode backward reads)."""
    return (out, ws) if keep_ws else out


def _run_mma(lc: _Launch, a, p: Params, stream, error,
             *weights: torch.Tensor, train: Optional[UnitTrain] = None,
             grid: Optional[Grid] = None, branch: Optional[str] = None,
             entry: str = "") -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The unit's bf16 launch on the tensor cores through C entry
    ``qv_{entry}`` (its route), or ValueError with the reason ``error(g)``
    gives for widths its kernel does not take: ``weights`` cast to bf16
    once per call, which is the kernel's own rounding of them (cp.async
    copies them as they are).  One block per SM walks the tiles of 64
    token rows (on the host, one block walks them all); in training
    (``train``) at most ``grid.blocks``, or the clusters
    :func:`cluster_grid` gives an entry of :data:`CLUSTER_FWD`, and a unit
    that writes the bank (``branch``) gets the partial workspace of those
    blocks (clusters).  Returns the
    guard workspace and, in training with ``branch``, the bank partials'
    sum."""
    err = error(lc.g)
    if err is not None:
        raise ValueError(f"{lc.name}: {err}")
    w16 = [w.to(torch.bfloat16).contiguous() for w in weights]
    lc.held += w16
    tiles = -(-lc.b * lc.g.n // 64)
    if entry in CLUSTER_FWD:      # clusters of two CTAs, a sample each
        blocks = cluster_grid(entry, grid, lc.b, lc.device).blocks
    elif train is not None:
        blocks = min(tiles, grid.blocks)
    else:
        blocks = (min(tiles, _sm_count(lc.device))
                  if lc.device.type == "cuda" else 1)
    part = None
    if train is not None and branch is not None:
        part = _bank_write(lc, a, p, branch, train,
                           Grid(blocks, grid.reduce))
    d = _dims(lc.g, lc.b, p, blocks, 1 if grid is None else grid.reduce,
              None if train is None else train.rng)
    extra = tuple(w.data_ptr() for w in w16)
    if entry in _MMA_FWD256:      # and the unit's scratch
        extra += (_scratch256(lc, entry, d).data_ptr(),)
    ws = lc.run(a, d, stream, entry=entry, extra=extra)
    return ws, part


def _scratch256(lc: _Launch, entry: str, d: Dims) -> torch.Tensor:
    """The scratch buffer of one call of n=256 C entry ``qv_{entry}``
    (its intermediates), held by the launch."""
    n = getattr(lc.lib, f"qv_{entry}_scratch")(ctypes.byref(d))
    t = torch.empty(max(n, 1), device=lc.device)
    lc.held.append(t)
    return t


def launch_cga(lib, p: Params, xn, bank_k, bank_v, g: FusedGeom, dtype,
               stream=None, train: Optional[UnitTrain] = None,
               grid: Optional[Grid] = None, keep_ws: bool = False):
    lc = _Launch(lib, "unit_cga", g, dtype, xn, train is not None)
    c, pc = g.c, p["cga"]
    cpg = c // g.groups
    out = torch.empty_like(xn)
    a = CgaArgs()
    a.xn, a.out = lc.act(xn), lc.act(out)
    a.q_w, a.q_b = lc.dense(pc["q_proj"], cpg, g.cperg)
    a.k_w, a.k_b = lc.dense(pc["k_proj"], cpg, g.cperg)
    a.v_w, a.v_b = lc.dense(pc["v_proj"], cpg, g.cperg)
    a.bk_w, a.bk_b = lc.dense(pc["bank_k_proj"], c, g.cperg)
    a.bv_w, a.bv_b = lc.dense(pc["bank_v_proj"], c, g.cperg)
    a.bank_k, a.bank_v = _bank(lc, bank_k, bank_v)
    a.proj_w, a.proj_b = lc.dense(pc["proj"], g.groups * g.cperg, c)
    route = cga_route(g, dtype, train is not None)
    if route != "unit_cga":
        ws, part = _run_mma(lc, a, p, stream, cga_mma_error,
                            _cga_qkv_packed(p), pc["proj"]["kernel"],
                            train=train, grid=grid, branch="cga",
                            entry=route)
        if train is None:
            return _eval_out(out, ws, keep_ws)
        return out, part, ws
    if train is None:
        ws = lc.run(a, _fwd_dims(lc, p, None, None), stream)
        return _eval_out(out, ws, keep_ws)
    part = _bank_write(lc, a, p, "cga", train, grid)
    ws = lc.run(a, _fwd_dims(lc, p, train, grid), stream)
    return out, part, ws


def _cross_tail_args(lc: _Launch, p: Params, a: CrossTailArgs) -> None:
    g = lc.g
    c, pc, f = g.c, p["cross_attn"], p["ccf_ffn"]
    hb, hc = g.bottleneck_hidden, g.ccf_hidden
    a.cq_w, a.cq_b = lc.dense(pc["q_proj"], c, c)
    a.ck_w, a.ck_b = lc.dense(pc["k_proj"], c, c)
    a.cv_w, a.cv_b = lc.dense(pc["v_proj"], c, c)
    a.cp_w, a.cp_b = lc.dense(pc["proj"], c, c)
    for i, name in enumerate(_BRANCHES):
        a.norm_s[i], a.norm_b[i] = lc.ln(p[f"norm_{name}"], c)
        a.comp_w[i], a.comp_b[i] = lc.dense(p[f"compress_{name}"], c, g.d_c)
    a.fusion = lc.w(p["fusion"]["fusion_weights"], 4)
    a.bn1_w, a.bn1_b = lc.dense(p["bottleneck_mlp"]["fc1"], c, hb)
    a.bn2_w, a.bn2_b = lc.dense(p["bottleneck_mlp"]["fc2"], hb, c)
    a.norm2_s, a.norm2_b = lc.ln(p["norm2"], c)
    a.fc1_w, a.fc1_b = lc.dense(f["fc1"], c, hc)
    a.fc2_w, a.fc2_b = lc.dense(f["fc2"], hc, c)
    dw = f["dwconv"]
    a.dw_w = lc.w(dw["dwconv"]["weight"], hc, 1, 3, 3)
    if "bias" in dw["dwconv"]:
        a.dw_b = lc.w(dw["dwconv"]["bias"], hc)
    if g.stabilized_dwconv:
        a.dw_scale = lc.w(dw["scale"], hc)
    if g.stabilized_ccfffn:
        a.dwn_s, a.dwn_b = lc.ln(f["dwconv_norm"], hc)
        a.pdn_s, a.pdn_b = lc.ln(f["post_dwconv_norm"], hc)
        a.gamma = lc.w(f["gamma"], 1)


def launch_cross_tail(lib, p: Params, x, xn, out_swa, out_msda, out_cga,
                      bank_k, bank_v, g: FusedGeom, dtype, stream=None,
                      train: Optional[UnitTrain] = None,
                      grid: Optional[Grid] = None, keep_ws: bool = False):
    lc = _Launch(lib, "unit_cross_tail", g, dtype, x,
                 train is not None)
    y = torch.empty_like(x)
    a = CrossTailArgs()
    a.x, a.xn, a.y = lc.act(x), lc.act(xn), lc.act(y)
    a.swa, a.msda, a.cga = lc.act(out_swa), lc.act(out_msda), lc.act(out_cga)
    a.bank_k, a.bank_v = _bank(lc, bank_k, bank_v)
    _cross_tail_args(lc, p, a)
    route = cross_tail_route(g, dtype, train is not None)
    if route != "unit_cross_tail":
        ws, _ = _run_mma(lc, a, p, stream, cross_tail_mma_error,
                         *_cross_tail_packed(p), train=train, grid=grid,
                         entry=route)
    else:
        ws = lc.run(a, _fwd_dims(lc, p, train, grid), stream)
    return _eval_out(y, ws, keep_ws) if train is None else (y, ws)


def _mma_route(unit: str, error, g: FusedGeom, dtype,
               train: bool = False) -> str:
    """The C entry (``qv_{entry}``) a forward launch of ``unit`` takes, by
    dtype, widths and mode before the launch: bf16 on the tensor cores at
    n=64 (where other widths raise, with ``error``'s reason; training
    through its own entry) and at n=16 where ``error`` admits the widths,
    in eval and in training; float32, and bf16 at other n=16 widths, on
    the CUDA cores (float32 at n=64 in eval; in training it raises before
    this, kernel_geometry_error)."""
    if dtype == torch.bfloat16 and g.n == 256:
        return f"{unit}_mma_train256" if train else f"{unit}_mma256"
    if dtype == torch.bfloat16 and g.n != 16 and train:
        return f"{unit}_mma_train64"
    if dtype == torch.bfloat16 and (g.n != 16 or error(g) is None):
        return f"{unit}_mma"
    return unit


def swa_route(g: FusedGeom, dtype, train: bool = False) -> str:
    return _mma_route("unit_swa", swa_mma_error, g, dtype, train)


def msda_route(g: FusedGeom, dtype, train: bool = False) -> str:
    return _mma_route("unit_msda", msda_mma_error, g, dtype, train)


def cga_route(g: FusedGeom, dtype, train: bool = False) -> str:
    return _mma_route("unit_cga", cga_mma_error, g, dtype, train)


def cross_tail_route(g: FusedGeom, dtype, train: bool = False) -> str:
    return _mma_route("unit_cross_tail", cross_tail_mma_error, g, dtype,
                      train)


def _cga_qkv_packed(p: Params) -> torch.Tensor:
    """The CGA unit's q, k and v kernels side by side, [C / groups,
    3 cperg], as ``cga_mma_kernel`` reads them."""
    pc = p["cga"]
    return torch.cat([pc[k]["kernel"] for k in ("q_proj", "k_proj",
                                                "v_proj")], dim=1)


def _cross_tail_packed(p: Params) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cross/tail unit's dense kernels side by side, in the order of
    ``cross_tail_mma_kernel``'s CT_* column offsets: [C, 4C + 4 d_c + 2
    hidden] (the ones that read C rows) and [hidden, 2C]."""
    pc, f, bn = p["cross_attn"], p["ccf_ffn"], p["bottleneck_mlp"]
    w1 = [pc[k]["kernel"] for k in ("q_proj", "k_proj", "v_proj", "proj")]
    w1 += [p[f"compress_{name}"]["kernel"] for name in _BRANCHES]
    w1 += [bn["fc1"]["kernel"], f["fc1"]["kernel"]]
    return (torch.cat(w1, dim=1),
            torch.cat([bn["fc2"]["kernel"], f["fc2"]["kernel"]], dim=1))


# ---------------------------------------------------------------------------
# backward launches: the forward's inputs, its guard workspace and the
# output cotangents -> (input cotangents, {gradient field: tensor}).  With
# ``train`` the unit's masks are replayed; without it (the eval-mode
# backward, JAX's make_cores(train=False)) the kernels run with d.train
# off: no dropout, no drop-path, no bank partials.
# ---------------------------------------------------------------------------

def _rng(train: Optional[UnitTrain]) -> Optional[R.BlockRng]:
    return None if train is None else train.rng


def _leaf(p: Params, path: Tuple[str, ...]):
    node = p
    for k in path:
        if not isinstance(node, dict) or k not in node:
            return None
        node = node[k]
    return node


class _Grads:
    """A per-block gradient workspace [grid, wstride] laid out field by
    field, and views of the reduced sums.  Zeroed for the kernels that add
    into their slice; left as allocated (``zero=False``) for a kernel that
    stores every field of its slice without reading it
    (``swa_bwd_mma_kernel``, ``cga_bwd_mma_kernel``, and the four n=64
    backwards on clusters, :data:`CLUSTER_BWD`).  A cluster kernel's
    ``grid.blocks`` counts its clusters, a slice each."""

    def __init__(self, lc: _Launch, unit: str, p: Params, grid: Grid,
                 zero: bool = True):
        s, c = lc.g.bank_s, lc.g.c
        self.items = []           # (field, index or None, shape, offset)
        off = 0
        for name, path in GRADS[unit]:
            t = _leaf(p, path)
            if t is None:
                continue
            field, _, idx = name.partition(".")
            self.items.append((field, int(idx) if idx else None,
                               tuple(t.shape), off, path))
            off += t.numel()
        for field in ("bank_k", "bank_v"):
            self.items.append((field, None, (1, s, c), off, (field,)))
            off += s * c
        self.wstride = off
        self.gws = (torch.zeros if zero else torch.empty)(
            grid.blocks, off, device=lc.device)
        self.grad = torch.empty(off, device=lc.device)

    def fill(self, gs) -> None:
        base = self.gws.data_ptr()
        for field, idx, _, off, _ in self.items:
            if idx is None:
                setattr(gs, field, base + 4 * off)
            else:
                getattr(gs, field)[idx] = base + 4 * off

    def result(self) -> Dict[Tuple[str, ...], torch.Tensor]:
        out = {}
        for _, _, shape, off, path in self.items:
            n = int(np.prod(shape))
            out[path] = self.grad[off:off + n].view(shape)
        return out


def _bwd_common(lc: _Launch, bc: BwdCommon, bank_k, bank_v, ws, grads: _Grads,
                scratch: Optional[torch.Tensor] = None):
    kr = bank_k.to(lc.dtype).float().contiguous()
    vr = bank_v.to(lc.dtype).float().contiguous()
    bc.bank_kr, bc.bank_vr = kr.data_ptr(), vr.data_ptr()
    bc.flag = ws.data_ptr()
    bc.gws, bc.grad = grads.gws.data_ptr(), grads.grad.data_ptr()
    bc.wstride = grads.wstride
    if scratch is not None:
        bc.scratch = scratch.data_ptr()
        lc.held.append(scratch)
    lc.held += [kr, vr]


def _run_bwd(lc: _Launch, args, d: Dims, stream, entry: str,
             w16: Optional[torch.Tensor] = None,
             call_scratch: Optional[torch.Tensor] = None) -> None:
    """Launch backward C entry ``qv_{entry}`` (:func:`bwd_entry`); the
    tensor-core entries also take the packed bf16 weights ``w16``, the
    n=256 ones a scratch buffer of the call (``call_scratch``, or none)."""
    smem = getattr(lc.lib, f"qv_{entry}_smem")(ctypes.byref(d))
    if smem > SMEM_LIMIT:
        raise ValueError(f"{entry}: needs {smem} B of shared memory > "
                         f"{SMEM_LIMIT}")
    extra = () if w16 is None else (w16.data_ptr(),)
    if entry in _MMA_BWD256:
        extra += (0 if call_scratch is None else call_scratch.data_ptr(),)
    rc = getattr(lc.lib, f"qv_{entry}")(
        ctypes.byref(args), *extra, int(lc.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"{entry}: kernel launch failed with CUDA error "
                           f"{rc}")
    ROUTES[entry] += 1


def _bwd_scratch(lc: _Launch, entry: str, d: Dims, grid: Grid):
    """(the per-block scratch ``BwdCommon.scratch`` points at, the scratch
    of the call an n=256 entry takes beside its weights): the SWA n=256
    backward is the n=64 kernel's and takes the former, the other n=256
    backwards the latter (their kernel sequences' intermediates)."""
    per = getattr(lc.lib, f"qv_{entry}_scratch")(ctypes.byref(d))
    if entry in _MMA_BWD256 and entry != "unit_swa_bwd_mma256":
        return None, _scratch256(lc, entry, d)
    return torch.empty(grid.blocks * per, device=lc.device), None


def _bwd_weights(lc: _Launch, *weights: torch.Tensor) -> torch.Tensor:
    """The tensor-core backward's bf16 weights in one buffer: each
    weight, then each transposed (for the dgrads dy @ W^T), flattened in
    the order of the kernel's offsets; cast once per call."""
    w16 = [w.to(torch.bfloat16) for w in weights]
    out = torch.cat([w.reshape(-1) for w in w16]
                    + [w.t().reshape(-1) for w in w16])
    lc.held.append(out)
    return out


def launch_swa_bwd(lib, p: Params, x, bank_k, bank_v, g: FusedGeom, dtype,
                   stream, train: Optional[UnitTrain], grid: Grid, ws, d_out,
                   d_xn):
    """-> ((d_x, d_bank_k, d_bank_v), {param path: gradient})"""
    lc = _Launch(lib, "unit_swa", g, dtype, x, True)
    a = SwaBwdArgs()
    f = a.f
    c, ps = g.c, p["swa"]
    f.x = lc.act(x)
    f.norm1_s, f.norm1_b = lc.ln(p["norm1"], c)
    f.qkv_w, f.qkv_b = lc.dense(ps["qkv"], c, 3 * c)
    f.e_k = lc.w(ps["linformer"]["E_k"], g.ws2, g.lin_k)
    f.e_v = lc.w(ps["linformer"]["E_v"], g.ws2, g.lin_k)
    f.bank_k, f.bank_v = _bank(lc, bank_k, bank_v)
    f.proj_w, f.proj_b = lc.dense(ps["proj"], c, c)
    entry = bwd_entry("unit_swa", g, dtype)
    mma = entry != "unit_swa_bwd"
    grid = cluster_grid(entry, grid, lc.b, lc.device)
    f.d = _dims(g, lc.b, p, grid.blocks, grid.reduce, _rng(train))
    grads = _Grads(lc, "unit_swa", p, grid, zero=not mma)
    grads.fill(a.g)
    w16 = scratch = big = None
    if mma:                          # qkv, proj, then both transposed
        w16 = _bwd_weights(lc, ps["qkv"]["kernel"], ps["proj"]["kernel"])
        scratch, big = _bwd_scratch(lc, entry, f.d, grid)
    _bwd_common(lc, a.c, bank_k, bank_v, ws, grads, scratch)
    d_x = torch.empty_like(x)
    a.d_out, a.d_xn, a.d_x = lc.act(d_out), lc.act(d_xn), lc.act(d_x)
    _run_bwd(lc, a, f.d, stream, entry, w16, big)
    r = grads.result()
    return (d_x, r.pop(("bank_k",)), r.pop(("bank_v",))), r


def launch_msda_bwd(lib, p: Params, xn, bank_k, bank_v, g: FusedGeom, dtype,
                    stream, train: Optional[UnitTrain], grid: Grid, ws,
                    d_out):
    """-> ((d_xn, d_bank_k, d_bank_v), {param path: gradient})"""
    lc = _Launch(lib, "unit_msda", g, dtype, xn, True)
    a = MsdaBwdArgs()
    f = a.f
    c, pm = g.c, p["msda"]
    pad = pm["linformer"]["E_k"].shape[0]
    f.xn = lc.act(xn)
    f.sel_t = lc.w(_msda_sel_t(g, xn.device), g.n, g.msda_keep)
    f.qkv_w, f.qkv_b = lc.w(pm["qkv_kernel"], c, 3 * c), lc.w(
        pm["qkv_bias"], 3 * c)
    f.e_k = lc.w(pm["linformer"]["E_k"], pad, g.lin_k)
    f.e_v = lc.w(pm["linformer"]["E_v"], pad, g.lin_k)
    f.bank_k, f.bank_v = _bank(lc, bank_k, bank_v)
    f.proj_w, f.proj_b = lc.dense(pm["proj"], c, c)
    entry = bwd_entry("unit_msda", g, dtype)
    grid = cluster_grid(entry, grid, lc.b, lc.device)
    f.d = _dims(g, lc.b, p, grid.blocks, grid.reduce, _rng(train))
    f.d.msda_pad = pad
    grads = _Grads(lc, "unit_msda", p, grid, zero=entry not in CLUSTER_BWD)
    grads.fill(a.g)
    w16 = scratch = big = None
    if entry != "unit_msda_bwd":         # qkv, proj, then both transposed
        w16 = _bwd_weights(lc, pm["qkv_kernel"], pm["proj"]["kernel"])
        scratch, big = _bwd_scratch(lc, entry, f.d, grid)
    _bwd_common(lc, a.c, bank_k, bank_v, ws, grads, scratch)
    d_xn = torch.empty_like(xn)
    a.d_out, a.d_xn = lc.act(d_out), lc.act(d_xn)
    _run_bwd(lc, a, f.d, stream, entry, w16, big)
    r = grads.result()
    return (d_xn, r.pop(("bank_k",)), r.pop(("bank_v",))), r


def launch_cga_bwd(lib, p: Params, xn, bank_k, bank_v, g: FusedGeom, dtype,
                   stream, train: Optional[UnitTrain], grid: Grid, ws,
                   d_out):
    """-> ((d_xn, d_bank_k, d_bank_v), {param path: gradient})"""
    lc = _Launch(lib, "unit_cga", g, dtype, xn, True)
    a = CgaBwdArgs()
    f = a.f
    c, pc = g.c, p["cga"]
    cpg = c // g.groups
    f.xn = lc.act(xn)
    f.q_w, f.q_b = lc.dense(pc["q_proj"], cpg, g.cperg)
    f.k_w, f.k_b = lc.dense(pc["k_proj"], cpg, g.cperg)
    f.v_w, f.v_b = lc.dense(pc["v_proj"], cpg, g.cperg)
    f.bk_w, f.bk_b = lc.dense(pc["bank_k_proj"], c, g.cperg)
    f.bv_w, f.bv_b = lc.dense(pc["bank_v_proj"], c, g.cperg)
    f.bank_k, f.bank_v = _bank(lc, bank_k, bank_v)
    f.proj_w, f.proj_b = lc.dense(pc["proj"], g.groups * g.cperg, c)
    entry = bwd_entry("unit_cga", g, dtype)
    mma = entry != "unit_cga_bwd"
    grid = cluster_grid(entry, grid, lc.b, lc.device)
    f.d = _dims(g, lc.b, p, grid.blocks, grid.reduce, _rng(train))
    # (the n=256 backward adds into its slices)
    grads = _Grads(lc, "unit_cga", p, grid,
                   zero=not mma or entry in _MMA_BWD256)
    grads.fill(a.g)
    w16 = scratch = big = None
    if mma:                 # q | k | v, proj, then both transposed
        w16 = _bwd_weights(lc, _cga_qkv_packed(p), pc["proj"]["kernel"])
        scratch, big = _bwd_scratch(lc, entry, f.d, grid)
    _bwd_common(lc, a.c, bank_k, bank_v, ws, grads, scratch)
    d_xn = torch.empty_like(xn)
    a.d_out, a.d_xn = lc.act(d_out), lc.act(d_xn)
    _run_bwd(lc, a, f.d, stream, entry, w16, big)
    r = grads.result()
    return (d_xn, r.pop(("bank_k",)), r.pop(("bank_v",))), r


def launch_cross_tail_bwd(lib, p: Params, x, xn, out_swa, out_msda, out_cga,
                          bank_k, bank_v, g: FusedGeom, dtype, stream,
                          train: Optional[UnitTrain], grid: Grid, ws, d_y):
    """-> ((d_x, d_xn, d_swa, d_msda, d_cga, d_bank_k, d_bank_v),
    {param path: gradient})"""
    lc = _Launch(lib, "unit_cross_tail", g, dtype, x, True)
    a = CrossTailBwdArgs()
    f = a.f
    f.x, f.xn = lc.act(x), lc.act(xn)
    f.swa, f.msda, f.cga = lc.act(out_swa), lc.act(out_msda), lc.act(out_cga)
    f.bank_k, f.bank_v = _bank(lc, bank_k, bank_v)
    _cross_tail_args(lc, p, f)
    entry = bwd_entry("unit_cross_tail", g, dtype)
    grid = cluster_grid(entry, grid, lc.b, lc.device)
    f.d = _dims(g, lc.b, p, grid.blocks, grid.reduce, _rng(train))
    grads = _Grads(lc, "unit_cross_tail", p, grid,
                   zero=entry not in CLUSTER_BWD)
    grads.fill(a.g)
    scratch, big = _bwd_scratch(lc, entry, f.d, grid)
    _bwd_common(lc, a.c, bank_k, bank_v, ws, grads, scratch)
    outs = [torch.empty_like(x) for _ in range(5)]
    a.d_y = lc.act(d_y)
    a.d_x, a.d_xn, a.d_swa, a.d_msda, a.d_cga = (lc.act(t) for t in outs)
    w16 = None
    if entry != "unit_cross_tail_bwd":       # w1, w2, then both transposed
        w16 = _bwd_weights(lc, *_cross_tail_packed(p))
    _run_bwd(lc, a, f.d, stream, entry, w16, big)
    r = grads.result()
    return tuple(outs) + (r.pop(("bank_k",)), r.pop(("bank_v",))), r


# ---------------------------------------------------------------------------
# the units in training: autograd Functions over the kernels
# ---------------------------------------------------------------------------

_FWD = {"unit_swa": launch_swa, "unit_msda": launch_msda,
        "unit_cga": launch_cga, "unit_cross_tail": launch_cross_tail}
_BWD = {"unit_swa": launch_swa_bwd, "unit_msda": launch_msda_bwd,
        "unit_cga": launch_cga_bwd, "unit_cross_tail": launch_cross_tail_bwd}
# differentiable outputs of each unit (the rest are bank partials)
_N_DIFF_OUT = {"unit_swa": 2, "unit_msda": 1, "unit_cga": 1,
               "unit_cross_tail": 1}


def unit_params(unit: str, p: Params) -> List[Tuple[Tuple[str, ...],
                                                    torch.Tensor]]:
    """(path, tensor) of every parameter the unit differentiates into."""
    out = []
    for _, path in GRADS[unit]:
        t = _leaf(p, path)
        if t is not None:
            out.append((path, t))
    return out


def _zeros_if_none(grads, like):
    return [torch.zeros_like(t) if gr is None else gr.contiguous()
            for gr, t in zip(grads, like)]


class _FusedUnit(torch.autograd.Function):
    """One unit in training: forward kernel, backward kernel.  Saves the
    unit's inputs only (the JAX package's selective save of the fused
    units, fused_kernels.py:185-207)."""

    @staticmethod
    def forward(ctx, unit, p, g, dtype, train, n_batch, *tensors):
        batch = tensors[:n_batch]
        lib, stream = _cuda(batch[0], unit)
        grid = train_grid(batch[0].device, batch[0].shape[0])
        res = _FWD[unit](lib, p, *batch, g, dtype, stream, train, grid)
        LAUNCHES[unit] += 1
        *outs, ws = res
        n = _N_DIFF_OUT[unit]
        parts = []
        for part in outs[n:]:          # [2, S, C] -> part_k, part_v
            parts += [part[0].clone(), part[1].clone()]
        ctx.mark_non_differentiable(*parts)
        ctx.save_for_backward(*batch, ws)
        ctx.unit, ctx.p, ctx.g, ctx.dtype, ctx.train, ctx.grid = (
            unit, p, g, dtype, train, grid)
        return tuple(outs[:n]) + tuple(parts)

    @staticmethod
    def backward(ctx, *cots):
        *batch, ws = ctx.saved_tensors
        unit = ctx.unit
        n = _N_DIFF_OUT[unit]
        outs_like = [batch[0]] * n
        cots = _zeros_if_none(cots[:n], outs_like)
        cots = [t.to(ctx.dtype).contiguous() for t in cots]
        lib, stream = _cuda(batch[0], unit + "_bwd")
        d_in, wg = _BWD[unit](lib, ctx.p, *batch, ctx.g, ctx.dtype, stream,
                              ctx.train, ctx.grid, ws, *cots)
        LAUNCHES[unit + "_bwd"] += 1
        d_w = [wg[path] for path, _ in unit_params(unit, ctx.p)]
        return (None,) * 6 + tuple(d_in) + tuple(d_w)


def _train_unit(unit: str, p: Params, batch, g: FusedGeom, dtype,
                train: UnitTrain):
    weights = [t for _, t in unit_params(unit, p)]
    return _FusedUnit.apply(unit, p, g, dtype, train, len(batch), *batch,
                            *weights)


class _EvalUnit(torch.autograd.Function):
    """One unit's eval forward under autograd: the same eval kernel (and
    C entry) as the forward under ``torch.inference_mode``, so the same
    outputs bit for bit; its guard workspace is kept for the backward,
    which launches the unit's backward kernel in eval mode (no masks, no
    bank partials: JAX's ``make_cores(train=False)`` paired with
    ``fused_pallas.py:244``'s ``bwd_call``) on the train grid.  The bank
    rows differentiate as JAX's ``diff`` group does."""

    @staticmethod
    def forward(ctx, unit, p, g, dtype, n_batch, *tensors):
        batch = tensors[:n_batch]
        lib, stream = _cuda(batch[0], unit)
        *outs, ws = _FWD[unit](lib, p, *batch, g, dtype, stream,
                               keep_ws=True)
        LAUNCHES[unit] += 1
        ctx.save_for_backward(*batch, ws)
        ctx.unit, ctx.p, ctx.g, ctx.dtype = unit, p, g, dtype
        return tuple(outs)

    @staticmethod
    def backward(ctx, *cots):
        *batch, ws = ctx.saved_tensors
        unit = ctx.unit
        cots = [t.to(ctx.dtype).contiguous()
                for t in _zeros_if_none(cots, [batch[0]] * len(cots))]
        lib, stream = _cuda(batch[0], unit + "_bwd")
        grid = train_grid(batch[0].device, batch[0].shape[0])
        d_in, wg = _BWD[unit](lib, ctx.p, *batch, ctx.g, ctx.dtype, stream,
                              None, grid, ws, *cots)
        LAUNCHES[unit + "_bwd"] += 1
        d_w = [wg[path] for path, _ in unit_params(unit, ctx.p)]
        return (None,) * 5 + tuple(d_in) + tuple(d_w)


def eval_vjp_error(unit: str, g: FusedGeom, dtype) -> Optional[str]:
    """Why a gradient cannot flow through ``unit``'s eval forward on the
    card (None if it can): its backward kernel must take geometry ``g``
    in ``dtype``, as in training (float32 at n=64 is ROADMAP queue 2 item
    2d's)."""
    err = kernel_geometry_error(g, True, dtype)
    if err is None and g.n == 256:
        err = ("the eval-mode backward at n=256 (Grad-CAM and rollout on "
               "qavit_v2_extreme_tin's blocks) is not ported (ROADMAP queue "
               "2 item 2e)")
    if err is None:
        try:
            bwd_entry(unit, g, dtype)
        except ValueError as e:
            err = str(e)
    if err is None:
        return None
    return (f"{unit}: a gradient through the eval forward needs the "
            f"unit's backward kernel, which cannot run here: {err}")


def _wants_vjp(unit: str, p: Params, batch) -> bool:
    """True where autograd records the eval forward: grad mode on and
    some input of the unit (a token tensor, a bank row, a weight)
    requiring a gradient."""
    if not torch.is_grad_enabled():
        return False
    return any(t.requires_grad for t in batch) or any(
        t.requires_grad for _, t in unit_params(unit, p))


def _eval_unit(unit: str, p: Params, batch, g: FusedGeom, dtype):
    """The unit's eval forward on the card: through :class:`_EvalUnit`
    where autograd needs its VJP (a shape the backward kernels do not
    take raises before the launch), else the plain launch."""
    if _wants_vjp(unit, p, batch):
        err = eval_vjp_error(unit, g, dtype)
        if err is not None:
            raise ValueError(err)
        weights = [t for _, t in unit_params(unit, p)]
        out = _EvalUnit.apply(unit, p, g, dtype, len(batch), *batch,
                              *weights)
        return out if len(out) > 1 else out[0]
    lib, stream = _cuda(batch[0], unit)
    out = _FWD[unit](lib, p, *batch, g, dtype, stream)
    LAUNCHES[unit] += 1
    return out


# ---------------------------------------------------------------------------
# the wrappers the fused block calls
# ---------------------------------------------------------------------------

def _cuda(t: torch.Tensor, name: str):
    """(library, stream) for a launch on t's card; raises off CUDA."""
    if t.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {t.device}")
    return (bind(build.load().lib),
            torch.cuda.current_stream(t.device).cuda_stream)


def unit_swa(p: Params, x, bank_k, bank_v, g: FusedGeom, dtype,
             train: Optional[UnitTrain] = None):
    """norm1 + SWA branch -> (out_swa, xn), and in training also the bank
    partial sums (part_k, part_v)."""
    if x.device.type == "cpu":
        return swa_plain(p, x, bank_k, bank_v, g, dtype, train)
    if train is not None:
        return _train_unit("unit_swa", p, (x, bank_k, bank_v), g, dtype,
                           train)
    return _eval_unit("unit_swa", p, (x, bank_k, bank_v), g, dtype)


def unit_msda(p: Params, xn, bank_k, bank_v, g: FusedGeom, dtype,
              train: Optional[UnitTrain] = None):
    """MSDA branch -> out_msda, or (out_msda, part_k, part_v) in training."""
    if xn.device.type == "cpu":
        return msda_plain(p, xn, bank_k, bank_v, g, dtype, train)
    if train is not None:
        return _train_unit("unit_msda", p, (xn, bank_k, bank_v), g, dtype,
                           train)
    return _eval_unit("unit_msda", p, (xn, bank_k, bank_v), g, dtype)


def unit_cga(p: Params, xn, bank_k, bank_v, g: FusedGeom, dtype,
             train: Optional[UnitTrain] = None):
    """CGA branch -> out_cga, or (out_cga, part_k, part_v) in training."""
    if xn.device.type == "cpu":
        return cga_plain(p, xn, bank_k, bank_v, g, dtype, train)
    if train is not None:
        return _train_unit("unit_cga", p, (xn, bank_k, bank_v), g, dtype,
                           train)
    return _eval_unit("unit_cga", p, (xn, bank_k, bank_v), g, dtype)


def unit_cross_tail(p: Params, x, xn, out_swa, out_msda, out_cga, bank_k,
                    bank_v, g: FusedGeom, dtype,
                    train: Optional[UnitTrain] = None):
    """Cross branch + block tail -> block output."""
    if x.device.type == "cpu":
        return cross_tail_plain(p, x, xn, out_swa, out_msda, out_cga,
                                bank_k, bank_v, g, dtype, train)
    batch = (x, xn, out_swa, out_msda, out_cga, bank_k, bank_v)
    if train is not None:
        return _train_unit("unit_cross_tail", p, batch, g, dtype, train)[0]
    return _eval_unit("unit_cross_tail", p, batch, g, dtype)
