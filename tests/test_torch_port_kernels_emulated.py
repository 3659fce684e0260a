"""The CUDA kernels' own source (qavit_tpu_torch/csrc), compiled for
the host with g++ against a small emulation of the CUDA built-ins
(tests/cuda_emulation/qv_emulate.h) and driven through the same ctypes
launch functions the card uses, held against the plain versions within
the stated tolerance (fused_kernels.TOLERANCE): the unit kernels at the
tiny width, the hqavit_c100 width (16 tokens, one SWA window) and the
hqavit_tiny_in geometry (64 tokens, four SWA windows, full width), the
flash-attention kernel at the 224 path's shapes, in float32 and bf16.
The bf16 flash kernel, the n=64 bf16 SWA, MSDA, CGA and cross/tail kernels
and the n=16 bf16 SWA, MSDA, CGA and cross/tail kernels at the hqavit_c100
width (four samples to a tile of 64 rows; at B=2 a short tile, at B=6 a
full tile and a short one) run on the tensor cores, which the route counts
(fused_kernels.ROUTES) confirm: the emulation rebuilds
mma.sync's and ldmatrix's
fragments from the PTX ISA's layouts, so their fragment indexing is
checked here too, after a self-test of the primitives (ldmatrix -> mma
against A @ B).  This checks the kernels' arithmetic, indexing and the
batch-wide NaN guard here; that nvcc accepts them and that they agree on
the card is checked by chip_smoke.py and the tests marked ``cuda``."""

import ctypes

import pytest
import torch

from qavit_tpu_torch.configs import get_preset
from qavit_tpu_torch.kernels import flash_attention as FA
from qavit_tpu_torch.kernels import fused_kernels as K
from qavit_tpu_torch.kernels import mma_selftest as MS
from qavit_tpu_torch.kernels.fused_params import QuadBlockParams
from qavit_tpu_torch.kernels.fused_ref import make_geom
from qavit_tpu_torch.nn.layers import init_weights, param_tree
from torch_port_emulation import emulation_library
from torch_port_emulation import two_cores  # noqa: F401 (autouse)
from torch_port_common import one_thread  # noqa: F401 (autouse)

B = 2


@pytest.fixture(scope="module")
def emu_lib(tmp_path_factory):
    return emulation_library(tmp_path_factory)


def _cfg(width):
    if width == "multiwindow":
        return get_preset("hqavit_tiny_in").model
    cfg = get_preset("hqavit_c100").model
    if width == "tiny":
        cfg = cfg.replace(embed_dim=48, linformer_k=8, msda_pad_len=32)
    return cfg


@pytest.fixture(scope="module",
                params=["tiny", "flagship_width", "multiwindow"])
def case(request):
    """Seed-made block weights (perturbed so LN scales, biases, fusion
    weights and gamma are not at their constant inits), bank and input."""
    cfg = _cfg(request.param)
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
    bank = [torch.randn(1, g.bank_s, g.c, generator=gen) * 0.5
            for _ in range(2)]
    x = torch.randn(B, g.n, g.c, generator=gen) * 2
    return g, param_tree(blk), bank, x


def _mma_entry(unit, g, dtype) -> str:
    """The C entry an SWA, MSDA or CGA launch must take: the tensor-core
    kernel in bf16 at C=192 (n=16 and n=64), else the CUDA-core kernel."""
    mma = dtype == torch.bfloat16 and g.c == 192
    return f"unit_{unit}_mma" if mma else f"unit_{unit}"


def _check(out, ref):
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert K.within_tolerance(out, ref), (K.max_abs_err(out, ref),
                                          ref.float().abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_swa_kernel(emu_lib, case, dtype):
    g, p, (bk, bv), x = case
    x = x.to(dtype)
    with torch.no_grad():
        K.reset_launches()
        out, xn = K.launch_swa(emu_lib, p, x, bk, bv, g, dtype)
        ref_out, ref_xn = K.swa_plain(p, x, bk, bv, g, dtype)
    _check(out, ref_out)
    _check(xn, ref_xn)
    assert K.ROUTES[_mma_entry("swa", g, dtype)] == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("unit", ["msda", "cga"])
def test_branch_kernel(emu_lib, case, dtype, unit):
    g, p, (bk, bv), x = case
    launch = {"msda": K.launch_msda, "cga": K.launch_cga}[unit]
    plain = {"msda": K.msda_plain, "cga": K.cga_plain}[unit]
    with torch.no_grad():
        xn = K.swa_plain(p, x.to(dtype), bk, bv, g, dtype)[1]
        K.reset_launches()
        _check(launch(emu_lib, p, xn, bk, bv, g, dtype),
               plain(p, xn, bk, bv, g, dtype))
    assert K.ROUTES[_mma_entry(unit, g, dtype)] == 1


def _cross_tail_entry(g, dtype) -> str:
    """The C entry a cross/tail launch must take: the tensor-core kernel
    in bf16 at C=192 (n=16 and n=64), else the CUDA-core kernel."""
    mma = dtype == torch.bfloat16 and g.c == 192
    return "unit_cross_tail_mma" if mma else "unit_cross_tail"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cross_tail_kernel(emu_lib, case, dtype):
    g, p, (bk, bv), x = case
    x = x.to(dtype)
    with torch.no_grad():
        o, xn = K.swa_plain(p, x, bk, bv, g, dtype)
        m = K.msda_plain(p, xn, bk, bv, g, dtype)
        c = K.cga_plain(p, xn, bk, bv, g, dtype)
        K.reset_launches()
        _check(K.launch_cross_tail(emu_lib, p, x, xn, o, m, c, bk, bv, g,
                                   dtype),
               K.cross_tail_plain(p, x, xn, o, m, c, bk, bv, g, dtype))
    assert K.ROUTES[_cross_tail_entry(g, dtype)] == 1


def test_nan_guard_is_batch_wide(emu_lib, case):
    """A NaN in one sample zeroes every sample's attention output, in the
    kernels as in the plain version: the SWA output becomes the proj bias
    everywhere and the block output agrees wherever it is finite."""
    g, p, (bk, bv), x = case
    x = x.clone()
    x[1, 3, 5] = float("nan")
    with torch.no_grad():
        out, xn = K.launch_swa(emu_lib, p, x, bk, bv, g, torch.float32)
        ref_out, ref_xn = K.swa_plain(p, x, bk, bv, g, torch.float32)
        bias = p["swa"]["proj"]["bias"]
        assert torch.equal(out, bias.expand_as(out))
        assert torch.equal(ref_out, out)
        m = K.msda_plain(p, ref_xn, bk, bv, g, torch.float32)
        c = K.cga_plain(p, ref_xn, bk, bv, g, torch.float32)
        y = K.launch_cross_tail(emu_lib, p, x, ref_xn, ref_out, m, c, bk, bv,
                                g, torch.float32)
        y_ref = K.cross_tail_plain(p, x, ref_xn, ref_out, m, c, bk, bv, g,
                                   torch.float32)
    assert torch.isnan(y[1]).any() and torch.isfinite(y[0]).all()
    _check(y[0], y_ref[0])


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("which", ["msda", "cross"])
def test_flash_kernel(emu_lib, which, dtype, rate):
    """The flash kernel at the 224 shapes (one sample, 4 heads of 48):
    the MSDA attention (196 queries, 80 keys, contiguous) and the cross
    attention (16 bank keys broadcast over the batch with stride 0, q a
    strided view), without and with the hashed dropout mask."""
    gen = torch.Generator().manual_seed(5)
    b, nq, h, d = 1, 196, 4, 48
    if which == "msda":
        q = torch.randn(b, nq, h, d, generator=gen)
        k, v = (torch.randn(b, 80, h, d, generator=gen) for _ in range(2))
    else:
        q = torch.randn(b, nq, 2 * h, d, generator=gen)[:, :, h:]
        k, v = (torch.randn(1, 16, h, d, generator=gen).expand(b, -1, -1, -1)
                for _ in range(2))
    q, k, v = (t.to(dtype) for t in (q, k, v))
    out = FA.launch(emu_lib, q, k, v, rate, 1234)
    _check(out, FA.plain(q, k, v, rate, 1234))


@pytest.mark.parametrize("trans", [False, True])
def test_mma_fragments(emu_lib, trans):
    """ldmatrix -> mma_bf16_16816 on a 16 x 16 A and a 16 x 16 B (two n8
    tiles) from a numpy seed, B stored [n][k] (ldmatrix) or [k][n]
    (ldmatrix.trans): the fragment helpers of mma.cuh against A @ B."""
    a, b = MS.inputs(0)
    d = MS.run(emu_lib, a, b, trans)
    ref = MS.plain(a, b, trans)
    assert (d - ref).abs().max().item() <= MS.TOLERANCE * ref.abs().max(
    ).item()


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("nkv,d", [(40, 40), (33, 36)])
def test_flash_kernel_padding(emu_lib, nkv, d, rate):
    """The bf16 tensor-core flash kernel where Nkv and D are not
    multiples of 16 (zero padding, padded keys masked) and the last query
    chunk is partial; at D=36 no row starts on 16 bytes, so every operand
    takes the plain loads instead of cp.async."""
    gen = torch.Generator().manual_seed(6)
    q = torch.randn(1, 150, 2, d, generator=gen).to(torch.bfloat16)
    k, v = (torch.randn(1, nkv, 2, d, generator=gen).to(torch.bfloat16)
            for _ in range(2))
    _check(FA.launch(emu_lib, q, k, v, rate, 77),
           FA.plain(q, k, v, rate, 77))


def test_msda_nan_guard_bf16(emu_lib, case):
    """bf16: a NaN in one sample's xn trips the MSDA unit's batch-wide
    guard; every sample's output is proj(0), as in the plain version."""
    g, p, (bk, bv), x = case
    dtype = torch.bfloat16
    with torch.no_grad():
        xn = K.swa_plain(p, x.to(dtype), bk, bv, g, dtype)[1].clone()
        xn[1, 3, 5] = float("nan")
        out = K.launch_msda(emu_lib, p, xn, bk, bv, g, dtype)
        ref = K.msda_plain(p, xn, bk, bv, g, dtype)
    assert torch.equal(out, ref)


def _check_guarded(out, ref):
    """NaNs where the plain version has them, the rest within tolerance."""
    nan = torch.isnan(ref)
    assert torch.equal(torch.isnan(out), nan)
    _check(out[~nan], ref[~nan])


@pytest.mark.parametrize("unit", ["swa", "cross_tail", "cga"])
def test_mma_nan_guard_bf16(emu_lib, case, unit):
    """bf16: a NaN in one sample trips the unit's batch-wide guard.  SWA
    (x): every sample's output is proj(0) and xn keeps the sample's NaN
    row; CGA (xn): every sample's output is proj(0); cross/tail (xn, read
    only by the cross branch's q): every sample's cross attention output
    is zero, the block output finite."""
    g, p, (bk, bv), x = case
    dtype = torch.bfloat16
    x = x.to(dtype)
    with torch.no_grad():
        if unit == "cga":
            xn = K.swa_plain(p, x, bk, bv, g, dtype)[1].clone()
            xn[1, 3, 5] = float("nan")
            K.reset_launches()
            out = K.launch_cga(emu_lib, p, xn, bk, bv, g, dtype)
            assert torch.equal(out, K.cga_plain(p, xn, bk, bv, g, dtype))
            assert K.ROUTES[_mma_entry("cga", g, dtype)] == 1
            return
        if unit == "swa":
            x[1, 3, 5] = float("nan")
            out, xn = K.launch_swa(emu_lib, p, x, bk, bv, g, dtype)
            ref, ref_xn = K.swa_plain(p, x, bk, bv, g, dtype)
            assert torch.equal(out, ref)
            _check_guarded(xn, ref_xn)
            return
        o, xn = K.swa_plain(p, x, bk, bv, g, dtype)
        m = K.msda_plain(p, xn, bk, bv, g, dtype)
        c = K.cga_plain(p, xn, bk, bv, g, dtype)
        xn = xn.clone()
        xn[1, 3, 5] = float("nan")
        args = (x, xn, o, m, c, bk, bv, g, dtype)
        K.reset_launches()
        y = K.launch_cross_tail(emu_lib, p, *args)
        ref = K.cross_tail_plain(p, *args)
    assert K.ROUTES[_cross_tail_entry(g, dtype)] == 1
    assert torch.isfinite(ref).all()
    _check_guarded(y, ref)


def _short_bank_case(width="multiwindow"):
    cfg = _cfg(width)
    g = make_geom(cfg)._replace(bank_s=12)
    gen = torch.Generator().manual_seed(8)
    p = param_tree(init_weights(QuadBlockParams(cfg, g), gen))
    bk, bv = (torch.randn(1, 12, g.c, generator=gen) * 0.5 for _ in range(2))
    x = torch.randn(B, g.n, g.c, generator=gen).to(torch.bfloat16)
    return g, p, bk, bv, x


def test_msda_kernel_short_bank(emu_lib):
    """The n=64 bf16 MSDA kernel with 12 bank rows: 44 keys a head, the
    last tile's 4 padded keys masked."""
    g, p, bk, bv, xn = _short_bank_case()
    with torch.no_grad():
        _check(K.launch_msda(emu_lib, p, xn, bk, bv, g, torch.bfloat16),
               K.msda_plain(p, xn, bk, bv, g, torch.bfloat16))


@pytest.mark.parametrize("unit", ["swa", "cross_tail", "cross_tail_n16",
                                  "swa_n16", "msda_n16", "cga", "cga_n16"])
def test_mma_kernel_short_bank(emu_lib, unit):
    """The n=64 bf16 SWA, CGA and cross/tail kernels, and the SWA, MSDA,
    CGA and cross/tail kernels at n=16 (hqavit_c100's width), with 12 bank
    rows: 44 keys a head in each SWA window and MSDA sample, 76 and 28 a
    CGA head, 12 in the cross attention, the padded keys masked (the
    projected bank rows past 12 are finite bias rows, the CGA's zeros)."""
    g, p, bk, bv, x = _short_bank_case(
        "flagship_width" if unit.endswith("n16") else "multiwindow")
    dtype = torch.bfloat16
    with torch.no_grad():
        K.reset_launches()
        ref_out, ref_xn = K.swa_plain(p, x, bk, bv, g, dtype)
        if unit.startswith("swa"):
            out, xn = K.launch_swa(emu_lib, p, x, bk, bv, g, dtype)
            _check(out, ref_out)
            _check(xn, ref_xn)
            assert K.ROUTES["unit_swa_mma"] == 1
            return
        if unit == "msda_n16":
            _check(K.launch_msda(emu_lib, p, ref_xn, bk, bv, g, dtype),
                   K.msda_plain(p, ref_xn, bk, bv, g, dtype))
            assert K.ROUTES["unit_msda_mma"] == 1
            return
        if unit.startswith("cga"):
            _check(K.launch_cga(emu_lib, p, ref_xn, bk, bv, g, dtype),
                   K.cga_plain(p, ref_xn, bk, bv, g, dtype))
            assert K.ROUTES["unit_cga_mma"] == 1
            return
        m = K.msda_plain(p, ref_xn, bk, bv, g, dtype)
        c = K.cga_plain(p, ref_xn, bk, bv, g, dtype)
        args = (x, ref_xn, ref_out, m, c, bk, bv, g, dtype)
        K.reset_launches()
        _check(K.launch_cross_tail(emu_lib, p, *args),
               K.cross_tail_plain(p, *args))
    assert K.ROUTES["unit_cross_tail_mma"] == 1


@pytest.mark.parametrize("unit", ["swa", "cross_tail", "cross_tail_n16",
                                  "swa_n16", "msda_n16", "cga", "cga_n16"])
def test_mma_geometry_errors(emu_lib, unit):
    """The n=64 bf16 SWA, CGA and cross/tail kernels take hqavit_tiny_in's
    geometry; at C=48 (which the float32 n=64 kernels take) the error
    names the width, and a bf16 n=64 eval launch raises it before any
    kernel runs (no fallback).  The cross/tail kernel also takes
    hqavit_c100's n=16 geometry; there the route is picked by dtype and
    width before the launch (bf16 at C=192 on the tensor cores; float32,
    and bf16 at C=48, on the CUDA cores), and its C entry returns ERR_ARGS
    (1) for C=48 and for n=64 in training, before it touches an
    argument.  So do the SWA, MSDA and CGA kernels at n=16 (their C
    entries also refuse MSDA's 17 pooled rows a sample, CGA's 17 bank rows
    and n=64 in training)."""
    if unit in ("swa_n16", "msda_n16", "cga_n16"):
        name = unit[:-4]
        error, route = {"swa": (K.swa_mma_error, K.swa_route),
                        "msda": (K.msda_mma_error, K.msda_route),
                        "cga": (K.cga_mma_error, K.cga_route)}[name]
        flagship, tiny = make_geom(_cfg("flagship_width")), make_geom(
            _cfg("tiny"))
        assert error(flagship) is None
        reason = error(tiny)
        assert reason is not None and "C=192" in reason
        for g, dtype, mma in ((flagship, torch.bfloat16, True),
                              (flagship, torch.float32, False),
                              (tiny, torch.bfloat16, False)):
            assert route(g, dtype) == f"unit_{name}" + ("_mma" if mma
                                                        else "")
        wide = make_geom(_cfg("multiwindow"))
        bad = [(tiny, None), (tiny, K.R.block_rng(1, 0.1, 0.1)),
               (wide, K.R.block_rng(1, 0.1, 0.1))]
        if name == "msda":
            bad.append((flagship._replace(msda_keep=17), None))
            assert error(bad[-1][0]) is not None
        if name == "cga":
            bad.append((flagship._replace(bank_s=17), None))
            assert error(bad[-1][0]) is not None
        p = param_tree(init_weights(QuadBlockParams(_cfg("tiny"), tiny),
                                    torch.Generator().manual_seed(2)))
        entry = getattr(emu_lib, f"qv_unit_{name}_mma")
        for g, rng in bad:
            args = K._ENTRY[f"unit_{name}"]()
            args.d = K._dims(g, B, p, 1, 1, rng)
            assert entry(ctypes.byref(args), None, None, 1, None) == 1
        return
    if unit == "cross_tail_n16":
        flagship, tiny = make_geom(_cfg("flagship_width")), make_geom(
            _cfg("tiny"))
        assert K.cross_tail_mma_error(flagship) is None
        reason = K.cross_tail_mma_error(tiny)
        assert reason is not None and "C=192" in reason
        for g, dtype, entry in (
                (flagship, torch.bfloat16, "unit_cross_tail_mma"),
                (flagship, torch.float32, "unit_cross_tail"),
                (tiny, torch.bfloat16, "unit_cross_tail")):
            assert K.cross_tail_route(g, dtype) == entry
        wide = make_geom(_cfg("multiwindow"))
        p = param_tree(init_weights(QuadBlockParams(_cfg("tiny"), tiny),
                                    torch.Generator().manual_seed(2)))
        for g, rng in ((tiny, None), (tiny, K.R.block_rng(1, 0.1, 0.1)),
                       (wide, K.R.block_rng(1, 0.1, 0.1))):
            args = K.CrossTailArgs()
            args.d = K._dims(g, B, p, 1, 1, rng)
            assert emu_lib.qv_unit_cross_tail_mma(ctypes.byref(args), None,
                                                  None, 1, None) == 1
        return
    error = {"swa": K.swa_mma_error, "cga": K.cga_mma_error,
             "cross_tail": K.cross_tail_mma_error}[unit]
    cfg = _cfg("multiwindow")
    assert error(make_geom(cfg)) is None
    narrow = cfg.replace(embed_dim=48)
    g = make_geom(narrow)
    assert K.kernel_geometry_error(g) is None
    reason = error(g)
    assert reason is not None and "C=192" in reason
    gen = torch.Generator().manual_seed(2)
    p = param_tree(init_weights(QuadBlockParams(narrow, g), gen))
    bk, bv = (torch.zeros(1, g.bank_s, g.c) for _ in range(2))
    x = torch.zeros(B, g.n, g.c, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="C=192"):
        if unit == "swa":
            K.launch_swa(None, p, x, bk, bv, g, torch.bfloat16)
        elif unit == "cga":
            K.launch_cga(None, p, x, bk, bv, g, torch.bfloat16)
        else:
            K.launch_cross_tail(None, p, x, x, x, x, x, bk, bv, g,
                                torch.bfloat16)


@pytest.mark.parametrize("unit", ["swa", "msda", "cga"])
def test_n16_mma_kernels_two_tiles(emu_lib, unit):
    """The n=16 bf16 SWA, MSDA and CGA tensor-core kernels at
    hqavit_c100's width over 6 samples: a full tile of four and a short
    one of two, each sample's rows loaded and stored alone."""
    cfg = _cfg("flagship_width")
    g = make_geom(cfg)
    gen = torch.Generator().manual_seed(9)
    p = param_tree(init_weights(QuadBlockParams(cfg, g), gen))
    bk, bv = (torch.randn(1, g.bank_s, g.c, generator=gen) * 0.5
              for _ in range(2))
    dtype = torch.bfloat16
    x = (torch.randn(6, g.n, g.c, generator=gen) * 2).to(dtype)
    with torch.no_grad():
        ref_out, ref_xn = K.swa_plain(p, x, bk, bv, g, dtype)
        K.reset_launches()
        if unit == "swa":
            out, xn = K.launch_swa(emu_lib, p, x, bk, bv, g, dtype)
            _check(xn, ref_xn)
            ref = ref_out
        elif unit == "msda":
            out = K.launch_msda(emu_lib, p, ref_xn, bk, bv, g, dtype)
            ref = K.msda_plain(p, ref_xn, bk, bv, g, dtype)
        else:
            out = K.launch_cga(emu_lib, p, ref_xn, bk, bv, g, dtype)
            ref = K.cga_plain(p, ref_xn, bk, bv, g, dtype)
    _check(out, ref)
    assert K.ROUTES[f"unit_{unit}_mma"] == 1
