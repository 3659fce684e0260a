"""The port's flat QAViT eval forward (``qavit_tpu_torch/nn/branches.py``,
``nn/block.py`` ``BranchQuadBlock``, ``nn/models.py`` ``QAViT``) against
the JAX package's flax modules on shared seed-made weights: each branch,
the whole model on ``tiny_plain_cfg`` and at the 224 geometry at full
width with depth cut to 2, in float32 and in bf16; the weight bridge on
the flat tree; the 224 presets and their entry points."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qavit_tpu.configs import get_preset as jax_get_preset
from qavit_tpu.nn import build_model as jax_build_model
from qavit_tpu.nn.bank import BankState as JaxBankState
from qavit_tpu.nn.branches import (ChannelGroupAttention as JaxCGA,
                                   CrossAttentionBranch as JaxCross,
                                   MultiScaleDilatedAttention as JaxMSDA,
                                   SpatialWindowAttention as JaxSWA)
from qavit_tpu_torch.ckpt.from_jax import jax_state_dict, load_jax_params
from qavit_tpu_torch.kernels import flash_attention as FA
from qavit_tpu_torch.kernels import fused_kernels as K
from qavit_tpu_torch.kernels.fused_params import block_dims
from qavit_tpu_torch.nn import branches as B
from qavit_tpu_torch.nn.bank import BankState
from qavit_tpu_torch.nn.block import (BranchQuadBlock, QuadAttentionBlock,
                                      flat_block)
from qavit_tpu_torch.nn.models import QAViT
from torch_port_common import (BF16_VS_F32, BF16_VS_JAX, assert_close,
                               jax_bundle, port_cfg, random_tree, to_np)

FLAT_PRESETS = ("qavit_224_v1", "qavit_v2", "qavit_224_v1_proc",
                "qavit_v2_proc224")


def _224_depth2(dtype="float32"):
    return jax_get_preset("qavit_224_v1_proc").model.replace(depth=2,
                                                             dtype=dtype)


@pytest.fixture(scope="module")
def flat224():
    """(JAX config, flax model, variables, images, JAX float32 logits)
    for the 224 geometry at full width, depth 2, batch 4."""
    jcfg = _224_depth2()
    jmodel, variables = jax_bundle(jcfg, seed=7)
    x = np.random.RandomState(8).standard_normal(
        (4, 224, 224, 3)).astype(np.float32)
    logits, _ = jax.jit(lambda v, x: jmodel.apply(v, x, train=False,
                                                  bank_count=0))(variables, x)
    return jcfg, jmodel, variables, x, np.asarray(logits)


def _port_logits(jcfg, variables, x):
    model = load_jax_params(QAViT(port_cfg(jcfg)), variables["params"]).eval()
    with torch.no_grad():
        return model(torch.from_numpy(x))


def test_224_eval_logits_match_jax(flat224):
    jcfg, _, variables, x, lj = flat224
    before = (dict(K.LAUNCHES), dict(FA.LAUNCHES))
    lt, state = _port_logits(jcfg, variables, x)
    assert lt.dtype == torch.float32 and lt.shape == (4, 100)
    assert_close(lt, lj)
    np.testing.assert_array_equal(
        to_np(state.k), variables["params"]["global_bank"]["global_k"])
    assert (dict(K.LAUNCHES), dict(FA.LAUNCHES)) == before


@pytest.mark.parametrize("impl", ["auto", "fused_block"])
def test_tiny_plain_eval_logits_match_jax(tiny_plain_cfg, impl):
    """``tiny_plain_cfg`` (16 tokens, one SWA window) through the branch
    path and, under ``fused_block``, through the fused units' plain
    versions, each against the same flax model."""
    jcfg = tiny_plain_cfg.replace(attn_impl=impl)
    jmodel, variables = jax_bundle(jcfg, seed=3)
    x = np.random.RandomState(4).standard_normal(
        (3, jcfg.img_size, jcfg.img_size, 3)).astype(np.float32)
    lj, _ = jax.jit(lambda v, x: jmodel.apply(v, x, train=False,
                                               bank_count=0))(variables, x)
    model = QAViT(port_cfg(jcfg))
    kind = QuadAttentionBlock if impl == "fused_block" else BranchQuadBlock
    assert all(type(b) is kind for b in model.blocks)
    load_jax_params(model, variables["params"]).eval()
    with torch.no_grad():
        lt, _ = model(torch.from_numpy(x))
    assert_close(lt, lj)


def test_224_bf16_logits_within_jax_own_bf16_distance(flat224):
    """bf16 at depth 2, held relative to JAX's own bf16-vs-float32
    distance on the same weights and images (a fixed 2**-6 of the logits
    would not hold JAX against itself at depth 8, ROADMAP queue 3)."""
    jcfg, _, variables, x, lj32 = flat224
    jcfg16 = _224_depth2("bfloat16")
    jm = jax_build_model(jcfg16)
    lj16 = np.asarray(jax.jit(lambda v, x: jm.apply(
        v, x, train=False, bank_count=0)[0])(variables, x))
    lt16 = to_np(_port_logits(jcfg16, variables, x)[0])
    scale = np.abs(lj32).max()
    jax_own = np.abs(lj16 - lj32).max() / scale
    vs_jax = np.abs(lt16 - lj16).max() / scale
    vs_f32 = np.abs(lt16 - lj32).max() / scale
    assert np.isfinite(lt16).all() and jax_own > 0
    assert vs_jax <= BF16_VS_JAX * jax_own, (vs_jax, jax_own)
    assert vs_f32 <= BF16_VS_F32 * jax_own, (vs_f32, jax_own)


def _branch_case(jcfg, seed, dtype):
    """Seed-made tokens [2, N, C] and bank rows for both frameworks."""
    rs = np.random.RandomState(seed)
    x = rs.standard_normal((2, jcfg.num_patches, jcfg.embed_dim)).astype(
        np.float32)
    k, v = (0.5 * rs.standard_normal((1, jcfg.bank.size, jcfg.embed_dim))
            .astype(np.float32) for _ in range(2))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jstate = JaxBankState(jnp.asarray(k), jnp.asarray(v), jnp.int32(0))
    state = BankState(torch.from_numpy(k), torch.from_numpy(v),
                      torch.tensor(0, dtype=torch.int32))
    return (jnp.asarray(x, jdt), jstate), (torch.from_numpy(x).to(dtype),
                                           state)


BRANCHES = {"swa": (JaxSWA, B.SpatialWindowAttention),
            "msda": (JaxMSDA, B.MultiScaleDilatedAttention),
            "cga": (JaxCGA, B.ChannelGroupAttention),
            "cross": (JaxCross, B.CrossAttentionBranch)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("branch", list(BRANCHES))
def test_branch_matches_flax(branch, dtype):
    """Each branch module against its flax module on the same params, at
    the 224 geometry (196 tokens, window 7, dilations (1, 2, 3))."""
    jcfg = _224_depth2()
    jcls, tcls = BRANCHES[branch]
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jmod = jcls(jcfg, dtype=jdt)
    (jx, jstate), (x, state) = _branch_case(jcfg, 11, dtype)
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jx, {},
                                              jstate, train=False))
    params = random_tree(shapes["params"], np.random.RandomState(12))
    want, _ = jmod.apply({"params": params}, jx, {}, jstate, train=False)
    cfg = port_cfg(jcfg)
    mod = load_jax_params(tcls(cfg, block_dims(cfg)), params)
    with torch.no_grad():
        got = mod(x, state, dtype)
    assert got.dtype == dtype
    assert_close(got, want, dtype)


def test_swa_pads_a_grid_that_does_not_tile(tiny_plain_cfg):
    """A 6x6 grid under 4x4 windows: padded to 8x8 and cropped back, as
    the flax branch does."""
    jcfg = tiny_plain_cfg.replace(img_size=24)
    (jx, jstate), (x, state) = _branch_case(jcfg, 13, torch.float32)
    jmod = JaxSWA(jcfg, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jx, {},
                                              jstate, train=False))
    params = random_tree(shapes["params"], np.random.RandomState(14))
    want, _ = jmod.apply({"params": params}, jx, {}, jstate, train=False)
    cfg = port_cfg(jcfg)
    mod = load_jax_params(B.SpatialWindowAttention(cfg, block_dims(cfg)),
                          params)
    with torch.no_grad():
        assert_close(mod(x, state, torch.float32), want)


def test_bridge_unstacks_the_flat_tree(flat224):
    jcfg, _, variables, _, _ = flat224
    params = variables["params"]
    assert set(params) == {"blocks", "global_bank", "head", "norm",
                           "patch_embed", "pos_embed"}
    model = QAViT(port_cfg(jcfg))
    sd = jax_state_dict(model, params)
    assert set(sd) == set(model.state_dict())
    for i in range(jcfg.depth):
        np.testing.assert_array_equal(
            sd[f"blocks.{i}.swa.qkv.kernel"].numpy(),
            params["blocks"]["swa"]["qkv"]["kernel"][i])
        np.testing.assert_array_equal(
            sd[f"blocks.{i}.ccf_ffn.dwconv.dwconv.weight"].numpy(),
            params["blocks"]["ccf_ffn"]["dwconv"]["dwconv"]["kernel"][i]
            .transpose(3, 2, 0, 1))
    missing = jax.tree_util.tree_map(lambda a: a, params)
    del missing["blocks"]["msda"]["linformer"]
    with pytest.raises(KeyError, match="missing"):
        jax_state_dict(model, missing)
    extra = jax.tree_util.tree_map(lambda a: a, params)
    extra["blocks"]["cga"]["extra"] = np.zeros((jcfg.depth, 3), np.float32)
    with pytest.raises(KeyError, match="extra leaf"):
        jax_state_dict(model, extra)


@pytest.mark.parametrize("name", FLAT_PRESETS)
def test_224_presets_match_jax(name):
    from qavit_tpu.data import get_pipeline
    from qavit_tpu_torch.configs import get_preset
    from qavit_tpu_torch.data.pipelines import get_pipeline as port_pipeline

    pj, pt = jax_get_preset(name), get_preset(name)
    assert dataclasses.asdict(pt.model) == dataclasses.asdict(pj.model)
    assert dataclasses.asdict(pt.train) == dataclasses.asdict(pj.train)
    assert pt.dataset == pj.dataset
    aug = get_pipeline(pt.dataset).aug
    mean, std = port_pipeline(pt.dataset).aug.mean, port_pipeline(
        pt.dataset).aug.std
    assert (tuple(mean), tuple(std)) == (tuple(aug.mean), tuple(aug.std))
    assert type(flat_block(pt.model)) is BranchQuadBlock


def test_flat_train_step_is_not_ported_yet():
    from qavit_tpu_torch.cli import bench
    from qavit_tpu_torch.configs import get_preset

    model = QAViT(get_preset("qavit_224_v1_proc").model.replace(depth=1))
    with pytest.raises(NotImplementedError, match="queue 1 item 1"):
        model(torch.zeros(1, 224, 224, 3), train=True)
    with pytest.raises(NotImplementedError, match="queue 1 item 1"):
        bench.main(["--preset", "qavit_224_v1_proc", "--train",
                    "--device", "cpu"])


def test_cli_serves_the_224_preset_on_cpu():
    """``evaluate`` and ``bench`` (eval forward) on qavit_224_v1_proc at
    full width and depth, a batch of 2 on the CPU (the plain versions)."""
    from qavit_tpu_torch.cli import bench, evaluate

    before = dict(FA.LAUNCHES)
    r = evaluate.main(["--preset", "qavit_224_v1_proc", "--synthetic",
                       "--batch-size", "2", "--batches", "1",
                       "--device", "cpu"])
    assert r["count"] == 2 and np.isfinite(r["loss"])
    row = bench.main(["--preset", "qavit_v2", "--batch-sizes", "2",
                      "--steps", "1", "--device", "cpu"])[0]
    assert row["mode"] == "eval" and row["img_per_s"] > 0
    assert FA.LAUNCHES == before
