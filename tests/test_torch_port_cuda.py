"""Tests of the port that need an NVIDIA GPU with the CUDA toolkit
(marked ``cuda``; without CUDA they skip).  On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Each unit kernel against its plain version within the stated tolerance
(fused_kernels.TOLERANCE), and a full-width hqavit_c100 forward that
launches every kernel 8 times and matches the plain path's logits."""

from unittest import mock

import pytest
import torch

from qavit_tpu_torch.configs import get_preset
from qavit_tpu_torch.kernels import fused_kernels as K
from qavit_tpu_torch.kernels.fused_params import QuadBlockParams
from qavit_tpu_torch.kernels.fused_ref import make_geom
from qavit_tpu_torch.nn.layers import init_weights, param_tree
from qavit_tpu_torch.nn.models import build_model

pytestmark = pytest.mark.cuda
PLAIN = {"unit_swa": K.swa_plain, "unit_msda": K.msda_plain,
         "unit_cga": K.cga_plain, "unit_cross_tail": K.cross_tail_plain}


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_units_match_plain_on_the_card(cuda, dtype):
    cfg = get_preset("hqavit_c100").model
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


def test_forward_launches_each_kernel_per_block(cuda):
    cfg = get_preset("hqavit_c100").model
    model = build_model(cfg, cuda, seed=0)
    x = torch.randn(8, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    x = x.to(cuda)
    K.reset_launches()
    with torch.inference_mode():
        logits, _ = model(x)
        counts = dict(K.LAUNCHES)
        with mock.patch.multiple(K, **PLAIN):
            ref, _ = model(x)
    assert counts == {name: cfg.depth for name in PLAIN}
    assert logits.shape == (8, cfg.num_classes)
    err = (logits - ref).abs().max().item()
    assert err <= 2.0 ** -4 * ref.abs().max().item(), err
