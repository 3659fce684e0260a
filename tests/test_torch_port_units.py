"""The port's plain unit functions (qavit_tpu_torch/kernels/fused_ref.py)
against the JAX package's twins (qavit_tpu/kernels/fused_ref.py) on the
same seed-made weights and inputs, at the tiny test width and at the
hqavit_c100 width.  These plain functions are the CPU path and the
reference the CUDA kernels are held against on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qavit_tpu.kernels import fused_ref as RJ
from qavit_tpu_torch.ckpt.from_jax import load_jax_params
from qavit_tpu_torch.kernels import fused_kernels as K
from qavit_tpu_torch.kernels import fused_ref as RT
from qavit_tpu_torch.kernels.fused_params import QuadBlockParams
from qavit_tpu_torch.nn.layers import param_tree
from torch_port_common import (assert_close, block_tree,
                               flagship_width_depth2, jax_bundle, port_cfg)

B = 3


@pytest.fixture(scope="module", params=["tiny", "flagship_width"])
def unit_case(request, tiny_cfg):
    """(JAX geometry, port geometry, JAX block params, port block tree,
    bank k/v, x) for one width."""
    jcfg = (tiny_cfg.replace(attn_impl="fused_block")
            if request.param == "tiny" else flagship_width_depth2())
    _, variables = jax_bundle(jcfg, seed=1)
    pj_np = block_tree(variables)
    cfg = port_cfg(jcfg)
    gt = RT.make_geom(cfg)
    blk = load_jax_params(QuadBlockParams(cfg, gt), pj_np)
    rs = np.random.RandomState(2)
    s, c = gt.bank_s, gt.c
    bank = [rs.standard_normal((1, s, c)).astype(np.float32) * 0.5
            for _ in range(2)]
    x = rs.standard_normal((B, gt.n, c)).astype(np.float32)
    pj = {k: v for k, v in pj_np.items()}
    return RJ.make_geom(jcfg), gt, pj, param_tree(blk), bank, x


def _jt(a, dtype=jnp.float32):
    return jnp.asarray(a, dtype)


def _tt(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def test_geometry_matches_jax(unit_case):
    gj, gt, *_ = unit_case
    assert tuple(gj) == tuple(gt)


def test_msda_mix_matrix_matches_jax(unit_case):
    gj, gt, *_ = unit_case
    np.testing.assert_array_equal(RJ.msda_mix_matrix(gj),
                                  RT.msda_mix_matrix(gt))


@pytest.mark.parametrize("branch", ["swa", "msda", "cga"])
def test_branch_matches_jax(unit_case, branch):
    gj, gt, pj, pt, (bk, bv), x = unit_case
    fj = {"swa": RJ.swa_ref, "msda": RJ.msda_ref, "cga": RJ.cga_ref}[branch]
    ft = {"swa": RT.swa_ref, "msda": RT.msda_ref, "cga": RT.cga_ref}[branch]
    oj, nj = fj(pj[branch], _jt(x), _jt(bk), _jt(bv), gj, jnp.float32)
    with torch.no_grad():
        ot, nt = ft(pt[branch], _tt(x), _tt(bk), _tt(bv), gt, torch.float32)
    assert_close(ot, oj, err_msg=f"{branch} out")
    assert_close(nt, nj, err_msg=f"{branch} normed")


def test_cross_matches_jax(unit_case):
    gj, gt, pj, pt, (bk, bv), x = unit_case
    oj = RJ.cross_ref(pj["cross_attn"], _jt(x), _jt(bk), _jt(bv), gj,
                      jnp.float32)
    with torch.no_grad():
        ot = RT.cross_ref(pt["cross_attn"], _tt(x), _tt(bk), _tt(bv), gt,
                          torch.float32)
    assert_close(ot, oj)


def test_tail_matches_jax(unit_case):
    gj, gt, pj, pt, _, x = unit_case
    rs = np.random.RandomState(3)
    outs = [rs.standard_normal(x.shape).astype(np.float32) for _ in range(4)]
    yj = RJ.tail_ref(pj, _jt(x), tuple(_jt(o) for o in outs), gj,
                     jnp.float32)
    with torch.no_grad():
        yt = RT.tail_ref(pt, _tt(x), tuple(_tt(o) for o in outs), gt,
                         torch.float32)
    assert_close(yt, yj)


def test_block_units_match_jax_block(unit_case):
    """The four unit wrappers on CPU tensors == the JAX fused block's
    eval forward (fused_quad_block_ref)."""
    from qavit_tpu.kernels.fused_block import fused_quad_block_ref
    from qavit_tpu.nn.bank import BankState as JBank
    from qavit_tpu_torch.kernels.fused_block import fused_quad_block
    from qavit_tpu_torch.nn.bank import BankState

    gj, gt, pj, pt, (bk, bv), x = unit_case
    yj, _ = fused_quad_block_ref(pj, _jt(x), JBank(_jt(bk), _jt(bv),
                                                   jnp.int32(0)),
                                 0.0, {}, None, gj, jnp.float32, False, None,
                                 None)
    before = dict(K.LAUNCHES)
    with torch.no_grad():
        yt, _ = fused_quad_block(pt, _tt(x), BankState(
            _tt(bk), _tt(bv), torch.tensor(0)), gt, torch.float32)
    assert_close(yt, yj)
    assert K.LAUNCHES == before, "plain CPU runs must not count launches"


def test_swa_bf16_matches_jax(unit_case):
    """One bf16 case: the rounding points of the port follow the JAX
    twins, so the outputs agree within two bf16 ulps of the largest."""
    gj, gt, pj, pt, (bk, bv), x = unit_case
    oj, _ = RJ.swa_ref(pj["swa"], _jt(x, jnp.bfloat16), _jt(bk), _jt(bv),
                       gj, jnp.bfloat16)
    with torch.no_grad():
        ot, _ = RT.swa_ref(pt["swa"], _tt(x, torch.bfloat16), _tt(bk),
                           _tt(bv), gt, torch.bfloat16)
    assert ot.dtype == torch.bfloat16
    assert_close(ot, oj, dtype=torch.bfloat16)


def test_dwconv3x3_matches_jax():
    rs = np.random.RandomState(4)
    x = rs.standard_normal((2, 16, 24)).astype(np.float32)
    k = rs.standard_normal((3, 3, 1, 24)).astype(np.float32)
    yj = RJ.dwconv3x3_ref(_jt(x), _jt(k), (4, 4), jnp.float32)
    yt = RT.dwconv3x3_ref(_tt(x), _tt(k.transpose(3, 2, 0, 1)), (4, 4),
                          torch.float32)
    assert_close(yt, yj)


def test_layer_norm_uses_fast_variance():
    """E[x^2] - mu^2 clamped at 0, as flax: a constant row normalises to
    the bias exactly, and a large-offset row matches the JAX twin."""
    rs = np.random.RandomState(5)
    x = (rs.standard_normal((4, 64)) + 30.0).astype(np.float32)
    x[0] = 3.0
    p = {"scale": np.full(64, 1.5, np.float32),
         "bias": np.linspace(-1, 1, 64).astype(np.float32)}
    yj = RJ.layer_norm(_jt(x), {k: _jt(v) for k, v in p.items()}, jnp.float32)
    yt = RT.layer_norm(_tt(x), {k: _tt(v) for k, v in p.items()},
                       torch.float32)
    np.testing.assert_array_equal(yt[0].numpy(), p["bias"])
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-3,
                               atol=1e-3)


def test_nan_guard_is_batch_wide():
    """A NaN in one sample zeroes the attention output of every sample
    (fused_ref.attention_core's whole-batch guard)."""
    rs = np.random.RandomState(6)
    q, k, v = (torch.from_numpy(rs.standard_normal((3, 16, 4, 8)).astype(
        np.float32)) for _ in range(3))
    q[1, 2, 0, 0] = float("nan")
    out = RT.attention_core(q, k, v, guard=True)
    assert torch.count_nonzero(out) == 0
    out = RT.attention_core(q, k, v, guard=False)
    assert torch.isnan(out[1]).any() and not torch.isnan(out[0]).any()
