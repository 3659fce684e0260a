"""qavit_v2_extreme_tin's token geometry under ``attn_impl="fused_block"``
(64 px, patch 4: 256 tokens on a 16x16 grid in 16 SWA windows of 16, 128
pooled MSDA rows), narrow and shallow (C=48, 4 heads, depth 2, float32),
against the JAX package on the CPU, whose fused block takes its jnp twin
(``qavit_tpu/kernels/fused_ref.py``) off the TPU, with seed-made weights
carried across by ``from_jax``:

* the eval logits, and the train forward's logits and bank state after
  three writes a block, at dropout and drop-path 0;
* one and three train steps against ``qavit_tpu.train.make_train_step``
  (``torch_port_steps``: each step's loss, ``grad_norm`` and per-leaf
  gradient norms, every parameter after the step), at dropout 0;
* each plain unit at n=256 (SWA, MSDA, CGA, cross, tail, and the block's
  four units) against its ``fused_ref`` twin;
* ``check_train_geometry`` on the preset, and ``cli.train --preset
  qavit_v2_extreme_tin --attn-impl fused_block --device cpu`` for 2
  epochs x 2 steps on a seed-made proc_tin cut (full width, depth 2).

Tolerances: float32 rtol 1e-4 and atol 1e-5 (``torch_port_common.F32``),
and ``torch_port_steps``' own for the steps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_steps as S
from qavit_tpu.configs import get_preset as jax_get_preset
from qavit_tpu.kernels import fused_ref as RJ
from qavit_tpu_torch.ckpt.from_jax import load_jax_params
from qavit_tpu_torch.configs import get_preset
from qavit_tpu_torch.kernels import fused_ref as RT
from qavit_tpu_torch.kernels.fused_params import QuadBlockParams
from qavit_tpu_torch.nn import layers as L
from qavit_tpu_torch.nn.block import QuadAttentionBlock
from qavit_tpu_torch.nn.layers import param_tree
from qavit_tpu_torch.nn.models import QAViT
from qavit_tpu_torch.train.steps import check_train_geometry
from torch_port_common import assert_close, block_tree, jax_bundle, port_cfg
from torch_port_common import one_thread  # noqa: F401 (autouse)

PRESET = "qavit_v2_extreme_tin"


def tin256(dtype: str = "float32"):
    """qavit_v2_extreme_tin's token geometry, C=48 with 4 heads, depth 2
    (linformer_k 8), under fused_block."""
    return jax_get_preset(PRESET).model.replace(
        embed_dim=48, depth=2, stage_blocks=(2,), linformer_k=8,
        dtype=dtype, attn_impl="fused_block")


@pytest.fixture(scope="module")
def bundle():
    jcfg = tin256().replace(dropout=0.0, drop_path=0.0)
    jmodel, variables = jax_bundle(jcfg, seed=2, batch=2)
    model = load_jax_params(QAViT(port_cfg(jcfg)), variables["params"])
    x = np.random.RandomState(4).standard_normal(
        (2, jcfg.img_size, jcfg.img_size, 3)).astype(np.float32)
    return jcfg, jmodel, variables, model, x


def test_geometry_is_the_presets():
    g = RT.make_geom(port_cfg(tin256()))
    full = RT.make_geom(get_preset(PRESET).model.replace(
        attn_impl="fused_block"))
    assert (g.n, g.nw, g.ws2, g.msda_keep) == (256, 16, 16, 128)
    assert (full.n, full.nw, full.msda_keep, full.c) == (256, 16, 128, 192)


def test_eval_logits_match_jax(bundle):
    jcfg, jmodel, variables, model, x = bundle
    want = jax.jit(lambda p, x: jmodel.apply({"params": p}, x, train=False))(
        variables["params"], x)
    want = want[0] if isinstance(want, tuple) else want
    assert all(type(b) is QuadAttentionBlock for b in model.blocks)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    got = got[0] if isinstance(got, tuple) else got
    assert_close(got, want)


def test_train_forward_and_bank_match_jax(bundle):
    jcfg, jmodel, variables, model, x = bundle
    logits, state = jax.jit(lambda p, x: jmodel.apply(
        {"params": p}, x, train=True, bank_count=0,
        rngs={"dropout": jax.random.PRNGKey(1)}))(variables["params"], x)
    model.train()
    with torch.no_grad():
        plog, pstate = model(torch.from_numpy(x), train=True, bank_count=0,
                             rng=L.DropoutRng(0, "cpu"))
    model.eval()
    assert_close(plog, logits)
    assert_close(pstate.k, state.k)
    assert_close(pstate.v, state.v)
    assert int(pstate.count) == int(state.count) == 3 * jcfg.depth
    assert float((pstate.k - model.global_bank.global_k).detach().abs()
                 .max()) > 0


@pytest.fixture(scope="module")
def runs():
    return S.run_case("extreme", tin256())


@pytest.mark.parametrize("steps", [1, 3])
def test_train_steps_match_jax(runs, steps):
    S.check_case(runs, steps)


@pytest.fixture(scope="module")
def units():
    """(JAX geometry, port geometry, JAX block params, port block tree,
    bank k/v, x) at n=256."""
    jcfg = tin256()
    _, variables = jax_bundle(jcfg, seed=1)
    pj = block_tree_flat(variables)
    cfg = port_cfg(jcfg)
    gt = RT.make_geom(cfg)
    blk = load_jax_params(QuadBlockParams(cfg, gt), pj)
    rs = np.random.RandomState(2)
    bank = [rs.standard_normal((1, gt.bank_s, gt.c)).astype(np.float32) * 0.5
            for _ in range(2)]
    x = rs.standard_normal((2, gt.n, gt.c)).astype(np.float32)
    return RJ.make_geom(jcfg), gt, pj, param_tree(blk), bank, x


def block_tree_flat(variables):
    """The first block's params of the flat QAViT (scan axis removed)."""
    params = variables["params"]
    if "blocks" in params:
        return jax.tree_util.tree_map(lambda a: a[0], params["blocks"])
    return block_tree(variables)


def _jt(a):
    return jnp.asarray(a, jnp.float32)


def _tt(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.mark.parametrize("unit", ["swa", "msda", "cga", "cross", "tail",
                                  "block"])
def test_plain_units_match_fused_ref(units, unit):
    """Each plain unit at n=256 against its JAX twin (float32, rtol 1e-4,
    atol 1e-5); the block as the four unit wrappers on CPU tensors
    against ``fused_quad_block_ref``."""
    gj, gt, pj, pt, (bk, bv), x = units
    assert tuple(gj) == tuple(gt)
    if unit in ("swa", "msda", "cga"):
        fj = {"swa": RJ.swa_ref, "msda": RJ.msda_ref, "cga": RJ.cga_ref}[unit]
        ft = {"swa": RT.swa_ref, "msda": RT.msda_ref, "cga": RT.cga_ref}[unit]
        oj, nj = fj(pj[unit], _jt(x), _jt(bk), _jt(bv), gj, jnp.float32)
        with torch.no_grad():
            ot, nt = ft(pt[unit], _tt(x), _tt(bk), _tt(bv), gt,
                        torch.float32)
        assert_close(ot, oj, err_msg=f"{unit} out")
        assert_close(nt, nj, err_msg=f"{unit} normed")
    elif unit == "cross":
        oj = RJ.cross_ref(pj["cross_attn"], _jt(x), _jt(bk), _jt(bv), gj,
                          jnp.float32)
        with torch.no_grad():
            ot = RT.cross_ref(pt["cross_attn"], _tt(x), _tt(bk), _tt(bv),
                              gt, torch.float32)
        assert_close(ot, oj)
    elif unit == "tail":
        rs = np.random.RandomState(3)
        outs = [rs.standard_normal(x.shape).astype(np.float32)
                for _ in range(4)]
        yj = RJ.tail_ref(pj, _jt(x), tuple(_jt(o) for o in outs), gj,
                         jnp.float32)
        with torch.no_grad():
            yt = RT.tail_ref(pt, _tt(x), tuple(_tt(o) for o in outs), gt,
                             torch.float32)
        assert_close(yt, yj)
    else:
        from qavit_tpu.kernels.fused_block import fused_quad_block_ref
        from qavit_tpu.nn.bank import BankState as JBank
        from qavit_tpu_torch.kernels.fused_block import fused_quad_block
        from qavit_tpu_torch.nn.bank import BankState

        yj, _ = fused_quad_block_ref(pj, _jt(x), JBank(_jt(bk), _jt(bv),
                                                       jnp.int32(0)),
                                     0.0, {}, None, gj, jnp.float32, False,
                                     None, None)
        with torch.no_grad():
            yt, _ = fused_quad_block(pt, _tt(x), BankState(
                _tt(bk), _tt(bv), torch.tensor(0)), gt, torch.float32)
        assert_close(yt, yj)


def test_check_train_geometry_passes():
    """The preset trains under fused_block (the n=256 kernels, bf16 on the
    card), and on the branch path."""
    mc = get_preset(PRESET).model
    check_train_geometry(mc)
    check_train_geometry(mc.replace(attn_impl="fused_block"))


def test_cli_train_runs_the_preset_under_fused_block(tmp_path, monkeypatch):
    """``cli.train --preset qavit_v2_extreme_tin --attn-impl fused_block
    --device cpu`` (the plain units on the CPU) at full width, depth cut
    to 2, 2 epochs x 2 steps at B=2 on a seed-made proc_tin of 8 + 4
    images: a finite two-epoch history."""
    import json

    from qavit_tpu_torch.cli import train as cli_train
    from qavit_tpu_torch.configs import presets as P
    from qavit_tpu_torch.data import procgen as TP

    TP.load_or_generate_proc_tin(str(tmp_path), n_train=8, n_test=4)
    p = P.PRESETS[PRESET]()
    cut = P.Preset(p.model.replace(depth=2, stage_blocks=(2,)), p.train,
                   p.dataset)
    monkeypatch.setitem(P.PRESETS, PRESET, lambda: cut)
    cli_train.main(["--preset", PRESET, "--attn-impl", "fused_block",
                    "--device", "cpu", "--batch-size", "2",
                    "--max-steps-per-epoch", "2", "--warmup-epochs", "1",
                    "--epochs", "2", "--data-root", str(tmp_path),
                    "--checkpoint-dir", str(tmp_path / "ck"),
                    "--log-dir", str(tmp_path / "lg")])
    h = json.loads((tmp_path / "lg" / "training_metrics.json")
                   .read_text())["history"]
    assert h["epoch"] == [1, 2]
    assert all(np.isfinite(v) for k in h for v in h[k])
