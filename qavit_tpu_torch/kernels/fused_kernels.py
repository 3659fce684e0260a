"""The four fused-block units of the eval forward, as hand-written CUDA
kernels for Hopper (``qavit_tpu_torch/csrc/unit_*.cu``).

Counterpart of ``qavit_tpu/kernels/fused_kernels.py`` (the TPU's Pallas
units ``core_swa``, ``core_msda``, ``core_cga``, ``core_cross_tail``):

    unit_swa         norm1 + SWA branch     -> out_swa, xn
    unit_msda        MSDA branch            -> out_msda
    unit_cga         CGA branch             -> out_cga
    unit_cross_tail  cross branch + tail    -> block output

Each wrapper takes the block's parameter tree (``fused_params``), runs
the unit's plain PyTorch version when its input lies on the CPU, and on
a CUDA tensor checks device, dtype, shape and contiguity, allocates its
outputs and launches its kernel on the current stream, or raises.  Every
launch adds one to ``LAUNCHES[name]``.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, Optional, Tuple

import torch

from qavit_tpu_torch.kernels import build
from qavit_tpu_torch.kernels import fused_ref as R
from qavit_tpu_torch.kernels.fused_ref import FusedGeom

Params = Dict[str, Any]

# launches of each kernel since the last reset (plain runs do not count)
LAUNCHES = {"unit_swa": 0, "unit_msda": 0, "unit_cga": 0,
            "unit_cross_tail": 0}


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


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain versions (the CPU path and the kernels' reference on the card)
# ---------------------------------------------------------------------------

def swa_plain(p: Params, x, bank_k, bank_v, g: FusedGeom, dtype):
    xn = R.layer_norm(x, p["norm1"], dtype)
    out, _ = R.swa_ref(p["swa"], xn, bank_k, bank_v, g, dtype)
    return out, xn


def msda_plain(p: Params, xn, bank_k, bank_v, g: FusedGeom, dtype):
    return R.msda_ref(p["msda"], xn, bank_k, bank_v, g, dtype)[0]


def cga_plain(p: Params, xn, bank_k, bank_v, g: FusedGeom, dtype):
    return R.cga_ref(p["cga"], xn, bank_k, bank_v, g, dtype)[0]


def cross_tail_plain(p: Params, x, xn, out_swa, out_msda, out_cga, bank_k,
                     bank_v, g: FusedGeom, dtype):
    out_cross = R.cross_ref(p["cross_attn"], xn, bank_k, bank_v, g, dtype)
    return R.tail_ref(p, x, (out_swa, out_msda, out_cga, out_cross), g,
                      dtype)


# ---------------------------------------------------------------------------
# C interface (mirrors csrc/common.cuh)
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_DIM_FIELDS = ("B", "c", "heads", "lin_k", "bank_s", "msda_keep", "groups",
               "cperg", "ccf_hidden", "bottleneck_hidden", "d_c", "guard",
               "stab_ccf", "stab_dw", "dw_bias")


class Dims(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int) for n in _DIM_FIELDS]


def _ptrs(names: str):
    return [(n, _P) for n in names.split()]


class SwaArgs(ctypes.Structure):
    _fields_ = _ptrs("x out xn norm1_s norm1_b qkv_w qkv_b e_k e_v bank_k "
                     "bank_v proj_w proj_b ws") + [("d", Dims)]


class MsdaArgs(ctypes.Structure):
    _fields_ = _ptrs("xn out sel_t qkv_w qkv_b e_k e_v bank_k bank_v proj_w "
                     "proj_b ws") + [("d", Dims)]


class CgaArgs(ctypes.Structure):
    _fields_ = _ptrs("xn out q_w q_b k_w k_b v_w v_b bk_w bk_b bv_w bv_b "
                     "bank_k bank_v proj_w proj_b ws") + [("d", Dims)]


class CrossTailArgs(ctypes.Structure):
    _fields_ = (_ptrs("x xn swa msda cga y cq_w cq_b ck_w ck_b cv_w cv_b "
                      "cp_w cp_b bank_k bank_v")
                + [(n, _P * 4) for n in ("norm_s", "norm_b", "comp_w",
                                         "comp_b")]
                + _ptrs("fusion bn1_w bn1_b bn2_w bn2_b norm2_s norm2_b "
                        "fc1_w fc1_b dwn_s dwn_b dw_w dw_b dw_scale pdn_s "
                        "pdn_b fc2_w fc2_b gamma ws")
                + [("d", Dims)])


_STRUCTS = (Dims, SwaArgs, MsdaArgs, CgaArgs, CrossTailArgs)
_ENTRY = {"unit_swa": SwaArgs, "unit_msda": MsdaArgs, "unit_cga": CgaArgs,
          "unit_cross_tail": CrossTailArgs}
_BOUND: Dict[int, bool] = {}
SMEM_LIMIT = 232448          # bytes of shared memory a block may opt in to


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points' types and check the struct layouts."""
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
    _BOUND[id(lib)] = True
    return lib


def kernel_geometry_error(g: FusedGeom) -> Optional[str]:
    """Why the kernels cannot run geometry ``g`` (None if they can)."""
    cpg = g.c // g.groups
    checks = (
        (g.n == 16 and g.nw == 1, "16 tokens in one SWA window"),
        (g.bank_s <= 16 and g.msda_keep <= 16, "at most 16 bank / MSDA rows"),
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


def _dims(g: FusedGeom, b: int, p: Params) -> Dims:
    dw = p["ccf_ffn"]["dwconv"]
    return Dims(B=b, c=g.c, heads=g.heads, lin_k=g.lin_k, bank_s=g.bank_s,
                msda_keep=g.msda_keep, groups=g.groups, cperg=g.cperg,
                ccf_hidden=g.ccf_hidden,
                bottleneck_hidden=g.bottleneck_hidden, d_c=g.d_c,
                guard=int(g.guard_nans), stab_ccf=int(g.stabilized_ccfffn),
                stab_dw=int(g.stabilized_dwconv),
                dw_bias=int("bias" in dw["dwconv"]))


class _Launch:
    """Argument checks and pointer collection for one launch."""

    def __init__(self, lib, name: str, g: FusedGeom, dtype, lead):
        if dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"{name}: working dtype must be float32 or "
                            f"bfloat16, got {dtype}")
        err = kernel_geometry_error(g)
        if err is not None:
            raise ValueError(f"{name}: {err}")
        self.lib, self.name, self.g, self.dtype = lib, name, g, dtype
        self.device = lead.device
        self.b = lead.shape[0]

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

    def run(self, args, p: Params, stream: Optional[int]) -> None:
        args.d = _dims(self.g, self.b, p)
        smem = getattr(self.lib, f"qv_{self.name}_smem")(ctypes.byref(args.d))
        if smem > SMEM_LIMIT:
            raise ValueError(f"{self.name}: needs {smem} B of shared memory "
                             f"> {SMEM_LIMIT}")
        ws = torch.zeros(2, dtype=torch.int32, device=self.device)
        args.ws = ws.data_ptr()
        rc = getattr(self.lib, f"qv_{self.name}")(
            ctypes.byref(args), int(self.dtype == torch.bfloat16), stream)
        if rc != 0:
            raise RuntimeError(f"{self.name}: kernel launch failed with CUDA "
                               f"error {rc}")


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


# ---------------------------------------------------------------------------
# launches (lib: a loaded kernel library, stream: a cudaStream_t or None)
# ---------------------------------------------------------------------------

def launch_swa(lib, p: Params, x, bank_k, bank_v, g: FusedGeom, dtype,
               stream=None):
    lc = _Launch(lib, "unit_swa", g, dtype, x)
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
    lc.run(a, p, stream)
    return out, xn


def launch_msda(lib, p: Params, xn, bank_k, bank_v, g: FusedGeom, dtype,
                stream=None):
    lc = _Launch(lib, "unit_msda", g, dtype, xn)
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
    lc.run(a, p, stream)
    return out


def launch_cga(lib, p: Params, xn, bank_k, bank_v, g: FusedGeom, dtype,
               stream=None):
    lc = _Launch(lib, "unit_cga", g, dtype, xn)
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
    lc.run(a, p, stream)
    return out


def launch_cross_tail(lib, p: Params, x, xn, out_swa, out_msda, out_cga,
                      bank_k, bank_v, g: FusedGeom, dtype, stream=None):
    lc = _Launch(lib, "unit_cross_tail", g, dtype, x)
    c, pc, f = g.c, p["cross_attn"], p["ccf_ffn"]
    hb, hc = g.bottleneck_hidden, g.ccf_hidden
    y = torch.empty_like(x)
    a = CrossTailArgs()
    a.x, a.xn, a.y = lc.act(x), lc.act(xn), lc.act(y)
    a.swa, a.msda, a.cga = lc.act(out_swa), lc.act(out_msda), lc.act(out_cga)
    a.cq_w, a.cq_b = lc.dense(pc["q_proj"], c, c)
    a.ck_w, a.ck_b = lc.dense(pc["k_proj"], c, c)
    a.cv_w, a.cv_b = lc.dense(pc["v_proj"], c, c)
    a.cp_w, a.cp_b = lc.dense(pc["proj"], c, c)
    a.bank_k, a.bank_v = _bank(lc, bank_k, bank_v)
    for i, name in enumerate(("swa", "msda", "cga", "cross")):
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
    lc.run(a, p, stream)
    return y


# ---------------------------------------------------------------------------
# the wrappers the fused block calls
# ---------------------------------------------------------------------------

def _cuda(t: torch.Tensor, name: str):
    """(library, stream) for a launch on t's card; raises off CUDA."""
    if t.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {t.device}")
    return (bind(build.load().lib),
            torch.cuda.current_stream(t.device).cuda_stream)


def unit_swa(p: Params, x, bank_k, bank_v, g: FusedGeom, dtype):
    """norm1 + SWA branch -> (out_swa, xn)."""
    if x.device.type == "cpu":
        return swa_plain(p, x, bank_k, bank_v, g, dtype)
    lib, stream = _cuda(x, "unit_swa")
    out = launch_swa(lib, p, x, bank_k, bank_v, g, dtype, stream)
    LAUNCHES["unit_swa"] += 1
    return out


def unit_msda(p: Params, xn, bank_k, bank_v, g: FusedGeom, dtype):
    """MSDA branch -> out_msda."""
    if xn.device.type == "cpu":
        return msda_plain(p, xn, bank_k, bank_v, g, dtype)
    lib, stream = _cuda(xn, "unit_msda")
    out = launch_msda(lib, p, xn, bank_k, bank_v, g, dtype, stream)
    LAUNCHES["unit_msda"] += 1
    return out


def unit_cga(p: Params, xn, bank_k, bank_v, g: FusedGeom, dtype):
    """CGA branch -> out_cga."""
    if xn.device.type == "cpu":
        return cga_plain(p, xn, bank_k, bank_v, g, dtype)
    lib, stream = _cuda(xn, "unit_cga")
    out = launch_cga(lib, p, xn, bank_k, bank_v, g, dtype, stream)
    LAUNCHES["unit_cga"] += 1
    return out


def unit_cross_tail(p: Params, x, xn, out_swa, out_msda, out_cga, bank_k,
                    bank_v, g: FusedGeom, dtype):
    """Cross branch + block tail -> block output."""
    if x.device.type == "cpu":
        return cross_tail_plain(p, x, xn, out_swa, out_msda, out_cga,
                                bank_k, bank_v, g, dtype)
    lib, stream = _cuda(x, "unit_cross_tail")
    y = launch_cross_tail(lib, p, x, xn, out_swa, out_msda, out_cga, bank_k,
                          bank_v, g, dtype, stream)
    LAUNCHES["unit_cross_tail"] += 1
    return y
