"""The CUDA kernels' own source (qavit_tpu_torch/csrc), compiled for
the host with g++ against a small emulation of the CUDA built-ins
(tests/cuda_emulation/qv_emulate.h) and driven through the same ctypes
launch functions the card uses, held against the plain versions within
the stated tolerance (fused_kernels.TOLERANCE): the unit kernels at the
tiny width, the hqavit_c100 width (16 tokens, one SWA window) and the
hqavit_tiny_in geometry (64 tokens, four SWA windows, full width), the
flash-attention kernel at the 224 path's shapes, in float32 and bf16.
This checks the kernels' arithmetic, indexing and the batch-wide NaN
guard here; that nvcc accepts them and that they agree on the card is
checked by chip_smoke.py and the tests marked ``cuda``."""

import ctypes
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from qavit_tpu_torch.configs import get_preset
from qavit_tpu_torch.kernels import flash_attention as FA
from qavit_tpu_torch.kernels import fused_kernels as K
from qavit_tpu_torch.kernels.build import CSRC
from qavit_tpu_torch.kernels.fused_params import QuadBlockParams
from qavit_tpu_torch.kernels.fused_ref import make_geom
from qavit_tpu_torch.nn.layers import init_weights, param_tree

EMU = Path(__file__).resolve().parent / "cuda_emulation"
B = 2


@pytest.fixture(scope="module")
def emu_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is needed to compile the kernels for the host")
    out = tmp_path_factory.mktemp("qv_emu") / "libqv_emu.so"
    cmd = [gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-DQV_EMULATE",
           "-x", "c++", f"-I{EMU}", *map(str, sorted(CSRC.glob("*.cu"))),
           "-o", str(out), "-lpthread"]
    subprocess.run(cmd, check=True, capture_output=True)
    return K.bind(ctypes.CDLL(str(out)))


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


def _check(out, ref):
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert K.within_tolerance(out, ref), (K.max_abs_err(out, ref),
                                          ref.float().abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_swa_kernel(emu_lib, case, dtype):
    g, p, (bk, bv), x = case
    x = x.to(dtype)
    with torch.no_grad():
        out, xn = K.launch_swa(emu_lib, p, x, bk, bv, g, dtype)
        ref_out, ref_xn = K.swa_plain(p, x, bk, bv, g, dtype)
    _check(out, ref_out)
    _check(xn, ref_xn)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("unit", ["msda", "cga"])
def test_branch_kernel(emu_lib, case, dtype, unit):
    g, p, (bk, bv), x = case
    launch = {"msda": K.launch_msda, "cga": K.launch_cga}[unit]
    plain = {"msda": K.msda_plain, "cga": K.cga_plain}[unit]
    with torch.no_grad():
        xn = K.swa_plain(p, x.to(dtype), bk, bv, g, dtype)[1]
        _check(launch(emu_lib, p, xn, bk, bv, g, dtype),
               plain(p, xn, bk, bv, g, dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cross_tail_kernel(emu_lib, case, dtype):
    g, p, (bk, bv), x = case
    x = x.to(dtype)
    with torch.no_grad():
        o, xn = K.swa_plain(p, x, bk, bv, g, dtype)
        m = K.msda_plain(p, xn, bk, bv, g, dtype)
        c = K.cga_plain(p, xn, bk, bv, g, dtype)
        _check(K.launch_cross_tail(emu_lib, p, x, xn, o, m, c, bk, bv, g,
                                   dtype),
               K.cross_tail_plain(p, x, xn, o, m, c, bk, bv, g, dtype))


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
