"""The v2 ConvNeXt-patchify stem (``hqavit_v2_c100``) through the port
against the JAX package on seed-made weights (``ckpt/from_jax.py``):
``SpatialLayerNorm``, the LayerScale ``ConvNeXtBlock`` and
``CNNStemConvNeXt`` module by module, the narrow model's eval logits in
float32 and bf16, 1 and 3 train steps, the analysis the trainer prints,
and a train state, checkpoint and transfer of a model with no BatchNorm.

LayerScale starts at 1e-6, where a block's branch is invisible, so every
``gamma`` is set to U(0.5, 1.5) before the forward checks.  The stem's
drop-path rates are fixed (0.1 in stages 3-4), so the steps run with
JAX's ``DropPath`` replaced by the identity and the port's masks off
(drop path 0: the two frameworks' draws cannot match).

Tolerances: float32, ``torch_port_common.F32`` (rtol 1e-4, atol 1e-5);
bf16 logits within BF16_VS_JAX x JAX's own bf16-vs-float32 distance
from JAX's bf16 logits (ROADMAP queue 3 item 3); the steps, those of
``tests/torch_port_steps.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from unittest import mock

import torch_port_steps as S
from qavit_tpu.configs import get_preset as jax_get_preset
from qavit_tpu.nn import build_model as jax_build_model
from qavit_tpu.nn import hybrid as JH
from qavit_tpu.obs import analyzer as JAN
from qavit_tpu_torch.ckpt import checkpoint as C
from qavit_tpu_torch.ckpt.from_jax import load_jax_params
from qavit_tpu_torch.configs import get_preset
from qavit_tpu_torch.nn import hybrid as H
from qavit_tpu_torch.nn.layers import DropPath
from qavit_tpu_torch.nn.models import HQAViT, build_model
from qavit_tpu_torch.obs import analyzer as AN
from qavit_tpu_torch.train.state import create_train_state
from torch_port_common import (BF16_VS_JAX, assert_close, jax_bundle,
                               port_cfg, random_tree, to_np)
from torch_port_common import one_thread  # noqa: F401 (autouse)

B = 2


def narrow_v2(dtype="float32"):
    """hqavit_v2_c100 (32 px, 8 x 8 tokens, 16 learned) narrow and
    shallow: C=48, depth 2, stem channels 8 / 12 / 16."""
    return jax_get_preset("hqavit_v2_c100").model.replace(
        embed_dim=48, depth=2, stage_blocks=(1, 1, 0, 0), linformer_k=8,
        cnn_c2=8, cnn_c3=12, cnn_c4=16, rrcv_channels=8, dtype=dtype,
        attn_impl="fused_block")


def gammas_of_order_one(tree, rs):
    """Every LayerScale ``gamma`` of a JAX tree set to U(0.5, 1.5)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            gammas_of_order_one(v, rs)
        elif k == "gamma" and np.asarray(v).ndim == 1 and v.shape[0] > 1:
            tree[k] = rs.uniform(0.5, 1.5, v.shape).astype(np.float32)
    return tree


def _module_vars(module, x, seed):
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), x))
    rs = np.random.RandomState(seed)
    return gammas_of_order_one(random_tree(shapes["params"], rs), rs)


def _images(size, seed=1, n=B, c=3):
    return np.random.RandomState(seed).standard_normal(
        (n, size, size, c)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_spatial_layer_norm_matches_flax(dtype):
    x = _images(8, c=12) * 3 + 1
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    fm = JH.SpatialLayerNorm(dtype=jd)
    params = _module_vars(fm, jnp.asarray(x), 2)
    ref = fm.apply({"params": params}, jnp.asarray(x))
    port = load_jax_params(H.SpatialLayerNorm(8, 8, 12), params)
    assert tuple(port.scale.shape) == (8, 8, 12)
    got = port(torch.from_numpy(x).to(td), td)
    assert got.dtype == td
    assert_close(got, np.asarray(ref.astype(jnp.float32)), td)


def test_layer_scale_convnext_block_matches_flax():
    x = _images(8, c=12)
    fm = JH.ConvNeXtBlock(12, 0.1, 1e-6, dtype=jnp.float32)
    params = _module_vars(fm, jnp.asarray(x), 3)
    assert params["gamma"].min() >= 0.5
    ref = fm.apply({"params": params}, jnp.asarray(x), False)
    port = load_jax_params(H.ConvNeXtBlock(12, 0.1, 1e-6), params)
    assert_close(port(torch.from_numpy(x), torch.float32), ref)


def test_layer_scale_starts_at_its_init():
    block = H.ConvNeXtBlock(12, 0.0, 1e-6)
    assert torch.equal(block.gamma, torch.full((12,), 1e-6))
    assert not hasattr(H.ConvNeXtBlock(12), "gamma")


@pytest.mark.parametrize("img", [32, 96])
def test_convnext_stem_matches_flax(img):
    """The three lateral maps (f2, f3, f4) at 32 and 96 px, eval."""
    x = _images(img, seed=4)
    fm = JH.CNNStemConvNeXt(8, 12, 16, dtype=jnp.float32)
    params = _module_vars(fm, jnp.asarray(x), 5)
    ref = fm.apply({"params": params}, jnp.asarray(x), False)
    port = load_jax_params(H.CNNStemConvNeXt(8, 12, 16, 3, img), params)
    got = port(torch.from_numpy(x), torch.float32)
    for g, r in zip(got, ref):
        assert tuple(g.shape) == (B, img // 4, img // 4, r.shape[-1])
        assert_close(g, r)


@pytest.fixture(scope="module")
def v2():
    jcfg = narrow_v2()
    _, variables = jax_bundle(jcfg, seed=7)
    assert "batch_stats" not in variables        # no BatchNorm in the stem
    gammas_of_order_one(variables["params"], np.random.RandomState(9))
    x = _images(32, seed=8)
    return jcfg, variables, x


def _jax_logits(jcfg, variables, x):
    jm = jax_build_model(jcfg)
    return np.asarray(jm.apply(variables, jnp.asarray(x), train=False)[0])


def _port_logits(jcfg, variables, x):
    model = load_jax_params(HQAViT(port_cfg(jcfg)),
                            variables["params"]).eval()
    assert isinstance(model.cnn_stem, H.CNNStemConvNeXt)
    with torch.no_grad():
        return model(torch.from_numpy(x))[0]


def test_v2_eval_logits_match_jax(v2):
    jcfg, variables, x = v2
    lt = _port_logits(jcfg, variables, x)
    assert lt.shape == (B, 100)
    assert_close(lt, _jax_logits(jcfg, variables, x))


def test_v2_bf16_logits_within_jax_own_bf16_distance(v2):
    jcfg, variables, x = v2
    lj32 = _jax_logits(jcfg, variables, x)
    jcfg16 = jcfg.replace(dtype="bfloat16")
    lj16 = _jax_logits(jcfg16, variables, x)
    lt16 = to_np(_port_logits(jcfg16, variables, x))
    scale = np.abs(lj32).max()
    jax_own = np.abs(lj16 - lj32).max() / scale
    vs_jax = np.abs(lt16 - lj16).max() / scale
    assert np.isfinite(lt16).all() and jax_own > 0
    assert vs_jax <= BF16_VS_JAX * jax_own, (vs_jax, jax_own)


class _NoDrop(fnn.Module):
    """JAX's DropPath at rate 0."""

    @fnn.compact
    def __call__(self, x, rate, train):
        return x


@pytest.fixture(scope="module")
def v2_steps():
    with mock.patch.object(JH, "DropPath", _NoDrop), \
            mock.patch.object(DropPath, "mask", lambda *a, **k: None):
        return S.run_case("differential", narrow_v2())


@pytest.mark.parametrize("steps", [1, 3])
def test_v2_train_steps_match_jax(v2_steps, steps):
    S.check_case(v2_steps, steps)


@pytest.mark.parametrize("name", ["hqavit_v2_c100", "hqavit_tiny_stl10",
                                  "hqavit_tiny_proc_stl", "simclr_stl10"])
def test_analyzer_matches_jax(name, capsys):
    """The trainer's printed analysis (parameters by module, the analytic
    FLOPs with the stem's branch, the memory estimate) of the new presets
    at full width."""
    mc, jmc = get_preset(name).model, jax_get_preset(name).model
    for batch in (1, 128):
        assert AN.analytic_flops(mc, batch) == JAN.analytic_flops(jmc, batch)
    jmodel = jax_build_model(jmc)
    dummy = jnp.zeros((2, jmc.img_size, jmc.img_size, 3))
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        dummy, train=True))["params"]
    with torch.device("meta"):
        model = HQAViT(mc)
    assert AN.param_breakdown(model) == JAN.param_breakdown(shapes)
    JAN.print_analysis(jmc, shapes)
    ref = capsys.readouterr().out
    AN.print_analysis(mc, model)
    assert capsys.readouterr().out == ref


def test_model_without_batch_norm_state_checkpoint_transfer(tmp_path):
    """hqavit_v2_c100 has no buffers: its train state, a checkpoint and
    its restore, and a transfer (nothing to merge) all take that."""
    mc = narrow_v2()
    model = build_model(port_cfg(mc), "cpu", seed=1)
    assert list(model.named_buffers()) == []
    state = create_train_state(model, True)
    assert state.ema_buffers == {}
    C.save_train_state(tmp_path / "ck", state, port_cfg(mc))
    fresh = create_train_state(build_model(port_cfg(mc), "cpu", seed=2),
                               True)
    C.restore_train_state(tmp_path / "ck", fresh)
    for (n, a), (_, b) in zip(model.named_parameters(),
                              fresh.model.named_parameters()):
        assert torch.equal(a, b), n
    other = build_model(port_cfg(mc.replace(num_classes=7)), "cpu", seed=3)
    C.load_for_transfer(tmp_path / "ck", other)
    src = dict(model.named_parameters())
    for n, p in other.named_parameters():
        if not n.startswith("head"):
            assert torch.equal(p, src[n]), n
