"""Tests of the port that need an NVIDIA GPU with the CUDA toolkit
(marked ``cuda``; without CUDA they skip).  On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Each unit kernel against its plain version within the stated tolerance
(fused_kernels.TOLERANCE) at the hqavit_c100 and the hqavit_proc_tin
geometries (16 tokens in one SWA window; 64 in four), a full-width
hqavit_c100 forward that launches every kernel 8 times and a full-depth
hqavit_proc_tin forward that launches each forward unit 12 times, both
matching the plain path's logits, each
unit's train-mode forward and backward kernel against the plain version
and autograd (fused_kernels.GRAD_TOLERANCE), and one full-width train
step that launches every forward and backward kernel 8 times; the
flash-attention kernel against its plain version at the 224 shapes, and
a full-depth qavit_224_v1_proc forward that launches it 16 times and
matches the plain path's logits."""

from unittest import mock

import pytest
import torch

from qavit_tpu_torch.configs import get_preset
from qavit_tpu_torch.kernels import flash_attention as FA
from qavit_tpu_torch.kernels import fused_kernels as K
from qavit_tpu_torch.kernels.fused_params import QuadBlockParams
from qavit_tpu_torch.kernels.fused_ref import make_geom
from qavit_tpu_torch.nn.layers import init_weights, param_tree
from qavit_tpu_torch.nn.models import build_model

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _units_match_plain(cuda, preset, dtype):
    cfg = get_preset(preset).model
    g = make_geom(cfg)
    gen = torch.Generator().manual_seed(0)
    p = param_tree(init_weights(QuadBlockParams(cfg, g), gen).to(cuda))
    bk, bv = ((torch.randn(1, g.bank_s, g.c, generator=gen) * 0.5).to(cuda)
              for _ in range(2))
    x = torch.randn(64, g.n, g.c, generator=gen).to(cuda, dtype)
    with torch.inference_mode():
        o, xn = K.unit_swa(p, x, bk, bv, g, dtype)
        ro, rxn = K.swa_plain(p, x, bk, bv, g, dtype)
        m = K.unit_msda(p, rxn, bk, bv, g, dtype)
        c = K.unit_cga(p, rxn, bk, bv, g, dtype)
        rm = K.msda_plain(p, rxn, bk, bv, g, dtype)
        rc = K.cga_plain(p, rxn, bk, bv, g, dtype)
        y = K.unit_cross_tail(p, x, rxn, ro, rm, rc, bk, bv, g, dtype)
        ry = K.cross_tail_plain(p, x, rxn, ro, rm, rc, bk, bv, g, dtype)
        torch.cuda.synchronize()
    for out, ref in ((o, ro), (xn, rxn), (m, rm), (c, rc), (y, ry)):
        assert K.within_tolerance(out, ref), K.max_abs_err(out, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_units_match_plain_on_the_card(cuda, dtype):
    _units_match_plain(cuda, "hqavit_c100", dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_multiwindow_units_match_plain_on_the_card(cuda, dtype):
    """The n=64 geometry (four SWA windows, 40 pooled MSDA rows)."""
    _units_match_plain(cuda, "hqavit_proc_tin", dtype)


def test_multiwindow_forward_launches_each_unit_per_block(cuda):
    """hqavit_proc_tin: 12 launches of each forward unit per forward, no
    backward or flash launch, logits as the plain path's."""
    cfg = get_preset("hqavit_proc_tin").model
    model = build_model(cfg, cuda, seed=0)
    x = torch.randn(8, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    x = x.to(cuda)
    K.reset_launches()
    FA.reset_launches()
    with torch.inference_mode():
        logits, _ = model(x)
        counts = {**K.LAUNCHES, **FA.LAUNCHES}
        with mock.patch.multiple(K, **K.PLAIN):
            ref, _ = model(x)
    assert counts == {n: cfg.depth if n in K.UNITS else 0 for n in counts}
    assert cfg.depth == 12 and logits.shape == (8, cfg.num_classes)
    err = (logits - ref).abs().max().item()
    assert err <= 2.0 ** -4 * ref.abs().max().item(), err


def test_forward_launches_each_kernel_per_block(cuda):
    cfg = get_preset("hqavit_c100").model
    model = build_model(cfg, cuda, seed=0)
    x = torch.randn(8, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    x = x.to(cuda)
    K.reset_launches()
    with torch.inference_mode():
        logits, _ = model(x)
        counts = dict(K.LAUNCHES)
        with mock.patch.multiple(K, **K.PLAIN):
            ref, _ = model(x)
    assert counts == {name: cfg.depth if name in K.UNITS else 0
                      for name in K.LAUNCHES}
    assert logits.shape == (8, cfg.num_classes)
    err = (logits - ref).abs().max().item()
    assert err <= 2.0 ** -4 * ref.abs().max().item(), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("unit", list(K.UNITS))
def test_backward_kernels_match_autograd_on_the_card(cuda, unit, dtype):
    from qavit_tpu_torch.kernels import build
    from qavit_tpu_torch.kernels import fused_ref as R
    from qavit_tpu_torch.kernels import unit_checks as UC
    from qavit_tpu_torch.nn.bank import GlobalBankParams

    cfg = get_preset("hqavit_c100").model
    g = make_geom(cfg)
    gen = torch.Generator().manual_seed(0)
    p = param_tree(init_weights(QuadBlockParams(cfg, g), gen).to(cuda))
    bank = init_weights(GlobalBankParams(cfg.bank, g.c), gen).to(cuda)
    bankp = {k: v.detach() for k, v in bank.write_params().items()}
    rows = tuple((torch.randn(1, g.bank_s, g.c, generator=gen) * 0.5).to(
        cuda) for _ in range(2))
    x = torch.randn(64, g.n, g.c, generator=gen).to(cuda, dtype)
    batch = UC.unit_inputs(p, g, dtype, x, rows)[unit]
    lib = K.bind(build.load().lib)
    train = K.UnitTrain(R.block_rng(3, 0.1, 0.1), bankp)
    grid = K.train_grid(cuda, 64)
    cots = UC.random_cotangents(unit, batch, dtype, gen)
    r = UC.check_unit(lib, unit, p, train, batch, g, dtype, grid, cots,
                      torch.cuda.current_stream().cuda_stream)
    assert r.ok, r


def test_train_step_launches_each_kernel_per_block(cuda):
    from qavit_tpu_torch.train.optim import make_schedule
    from qavit_tpu_torch.train.state import create_train_state
    from qavit_tpu_torch.train.steps import make_train_step

    preset = get_preset("hqavit_c100")
    cfg, tc = preset.model, preset.train
    model = build_model(cfg, cuda, seed=0)
    state = create_train_state(model, tc.use_ema, tc.ema_decay)
    step = make_train_step(cfg, tc, make_schedule(tc, 100))
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(16, 32, 32, 3, generator=gen).to(cuda)
    y = torch.randint(0, cfg.num_classes, (16,), generator=gen).to(cuda)
    K.reset_launches()
    m = step(state, x, y, 0)
    assert dict(K.LAUNCHES) == {n: cfg.depth for n in K.LAUNCHES}
    assert int(state.bank_count) == 3 * cfg.depth
    assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nkv,broadcast", [(80, False), (16, True),
                                           (144, False)])
def test_flash_kernel_matches_plain_on_the_card(cuda, nkv, broadcast, dtype,
                                                rate):
    gen = torch.Generator().manual_seed(2)
    b, nq, h, d = 32, 196, 4, 48 if nkv < 144 else 64
    q = torch.randn(b, nq, h, d, generator=gen).to(cuda, dtype)
    k, v = (torch.randn(1 if broadcast else b, nkv, h, d, generator=gen)
            .to(cuda, dtype).expand(b, -1, -1, -1) for _ in range(2))
    with torch.inference_mode():
        out = FA.flash_attention(q, k, v, rate, 99)
        torch.cuda.synchronize()
        ref = FA.plain(q, k, v, rate, 99)
    assert K.within_tolerance(out, ref), K.max_abs_err(out, ref)


def test_224_forward_launches_the_flash_kernel(cuda):
    cfg = get_preset("qavit_224_v1_proc").model
    model = build_model(cfg, cuda, seed=0)
    x = torch.randn(8, 224, 224, 3,
                    generator=torch.Generator().manual_seed(1)).to(cuda)
    K.reset_launches()
    FA.reset_launches()
    with torch.inference_mode():
        logits, _ = model(x)
        counts = {**K.LAUNCHES, **FA.LAUNCHES}
        with mock.patch.object(FA, "flash_attention", FA.plain):
            ref, _ = model(x)
    assert counts == {n: 2 * cfg.depth if n == "flash_attention" else 0
                      for n in counts}
    assert logits.shape == (8, cfg.num_classes)
    err = (logits - ref).abs().max().item()
    assert err <= 2.0 ** -4 * ref.abs().max().item(), err
