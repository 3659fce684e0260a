"""The port's interpretability (``qavit_tpu_torch/interpret``: Grad-CAM on
the pre-norm patch projection, attention rollout, the jet colormap and
the PNG writer, ``cli.evaluate --gradcam --rollout``) against the JAX
package's ``qavit_tpu/interpret`` on shared seed-made weights.

Tolerances: in float32 the CAM within 1e-3 of JAX's and the class equal
(the gradient of one logit through the whole model in another summation
order, then a min-max normalisation that divides by the CAM's range);
in bf16 the port's CAM within BF16_VS_JAX x JAX's own bf16-vs-float32 CAM
distance of JAX's bf16 CAM; rollout within 1e-4 (float32 softmax and
row-normalised products, no gradient)."""

import dataclasses
import math
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from qavit_tpu.interpret import attention_rollout as jax_rollout
from qavit_tpu.interpret import grad_cam as jax_grad_cam
from qavit_tpu_torch.ckpt.from_jax import load_jax_params
from qavit_tpu_torch.cli import evaluate as cli_evaluate
from qavit_tpu_torch.interpret import (attention_rollout, grad_cam,
                                       save_gradcam_overlay)
from qavit_tpu_torch.interpret import png as PNG
from qavit_tpu_torch.nn import taps
from qavit_tpu_torch.nn.models import HQAViT, QAViT
from torch_port_common import BF16_VS_JAX, jax_bundle, port_cfg
from torch_port_common import one_thread  # noqa: F401 (autouse)

CAM_TOL = 1e-3
ROLLOUT_TOL = 1e-4


def _flat196(tiny_plain_cfg):
    """The flat QAViT at 56 px, patch 4: 196 tokens on a 14x14 grid in 16
    SWA windows of 4x4 (the grid padded to 16x16), C=48, depth 2."""
    return tiny_plain_cfg.replace(img_size=56)


def _configs(tiny_cfg, tiny_plain_cfg):
    return {"hybrid": tiny_cfg, "flat": tiny_plain_cfg,
            "flat196": _flat196(tiny_plain_cfg)}


class _Jitted:
    """A flax model whose ``apply`` is jitted: JAX's ``grad_cam`` and
    ``attention_rollout`` call ``model.apply`` as they are, compiled
    once instead of dispatched op by op."""

    def __init__(self, model):
        self.cfg = model.cfg
        self._apply = jax.jit(model.apply,
                              static_argnames=("train", "mutable"))

    def apply(self, *args, mutable=False, **kw):
        if isinstance(mutable, list):
            mutable = tuple(mutable)
        return self._apply(*args, mutable=mutable, **kw)


def _bundle(jcfg, seed=7):
    """(flax model with a jitted apply, variables, the port model on the
    same weights, one normalised image [H, W, 3])."""
    jmodel, variables = jax_bundle(jcfg, seed=seed)
    jmodel = _Jitted(jmodel)
    cls = HQAViT if jcfg.hybrid else QAViT
    model = load_jax_params(cls(port_cfg(jcfg)), variables["params"],
                            variables.get("batch_stats")).eval()
    img = np.random.RandomState(seed + 1).standard_normal(
        (jcfg.img_size, jcfg.img_size, 3)).astype(np.float32)
    return jmodel, variables, model, img


_JAX_CAMS = {}


def _jax_cam(which, jcfg, dtype="float32"):
    """JAX's Grad-CAM of config ``which``'s image, computed once a module
    (each compiles the model's forward and its gradient)."""
    if (which, dtype) not in _JAX_CAMS:
        jmodel, variables, _, img = _bundle(jcfg)
        if dtype != "float32":
            jmodel = _Jitted(jax_bundle(jcfg.replace(dtype=dtype), seed=7)[0])
        cam, cls = jax_grad_cam(jmodel, variables, img)
        _JAX_CAMS[which, dtype] = np.asarray(cam), cls
    return _JAX_CAMS[which, dtype]


@pytest.mark.parametrize("which", ["hybrid", "flat"])
def test_gradcam_matches_jax_float32(which, tiny_cfg, tiny_plain_cfg):
    jcfg = _configs(tiny_cfg, tiny_plain_cfg)[which]
    jmodel, variables, model, img = _bundle(jcfg)
    cam_j, cls_j = _jax_cam(which, jcfg)
    cam, cls = grad_cam(model, img)
    assert cls == cls_j
    assert cam.shape == (jcfg.img_size, jcfg.img_size)
    assert np.isfinite(cam).all() and 0.0 <= cam.min() <= cam.max() <= 1.0
    np.testing.assert_allclose(cam, np.asarray(cam_j), atol=CAM_TOL, rtol=0)
    # a requested class
    cam2, cls2 = grad_cam(model, img, class_idx=3)
    cam2_j, _ = jax_grad_cam(jmodel, variables, img, class_idx=3)
    assert cls2 == 3
    np.testing.assert_allclose(cam2, np.asarray(cam2_j), atol=CAM_TOL,
                               rtol=0)


@pytest.mark.parametrize("which", ["hybrid", "flat"])
def test_gradcam_bf16_within_jax_own_distance(which, tiny_cfg,
                                              tiny_plain_cfg):
    jcfg = _configs(tiny_cfg, tiny_plain_cfg)[which]
    jb = jcfg.replace(dtype="bfloat16")
    _, variables, _, img = _bundle(jcfg)
    cam32_j, _ = _jax_cam(which, jcfg)
    cam16_j, cls16_j = _jax_cam(which, jcfg, "bfloat16")
    model16 = load_jax_params((HQAViT if jb.hybrid else QAViT)(port_cfg(jb)),
                              variables["params"],
                              variables.get("batch_stats")).eval()
    cam16, cls16 = grad_cam(model16, img, class_idx=cls16_j)
    own = np.abs(np.asarray(cam16_j) - np.asarray(cam32_j)).max()
    dist = np.abs(cam16 - np.asarray(cam16_j)).max()
    assert np.isfinite(cam16).all() and cls16 == cls16_j
    assert dist <= BF16_VS_JAX * own + 1e-6, (dist, own)


def test_gradcam_hook_is_pre_norm(tiny_cfg):
    """The perturbation sits on the pre-LN projection, where the reference
    hooks ``model.patch_embed.proj``: the hooked activation is not
    normalised, a uniform shift there vanishes through the LayerNorm, and
    a non-uniform one moves the logits."""
    _, _, model, img = _bundle(tiny_cfg)
    x = torch.from_numpy(img)[None]
    with torch.no_grad():
        acts = model.patch_embed(x, torch.float32, pre_norm=True)
        assert not np.allclose(acts[0].std(dim=-1).numpy(), 1.0, atol=0.05)
        l0, _ = model(x)
        l_uni, _ = model(x, patch_perturb=torch.ones_like(acts))
        gen = torch.Generator().manual_seed(7)
        l1, _ = model(x, patch_perturb=torch.randn(acts.shape,
                                                   generator=gen))
    np.testing.assert_allclose(l0.numpy(), l_uni.numpy(), atol=1e-5)
    assert not np.allclose(l0.numpy(), l1.numpy())


@pytest.mark.parametrize("which", ["hybrid", "flat", "flat196",
                                   "flat_fused_block"])
def test_rollout_matches_jax(which, tiny_cfg, tiny_plain_cfg):
    """Hybrid: the learner / upmix map; flat: the SWA back-mapped
    approximation, also at n=196 in 16 windows and for a model built with
    ``attn_impl="fused_block"`` (rebuilt on the branch path)."""
    cfgs = _configs(tiny_cfg, tiny_plain_cfg)
    cfgs["flat_fused_block"] = tiny_plain_cfg.replace(
        attn_impl="fused_block")
    jcfg = cfgs[which]
    jmodel, variables, model, img = _bundle(jcfg)
    sal_j = np.asarray(jax_rollout(jmodel, variables, img))
    sal = attention_rollout(model, img)
    assert sal.shape == sal_j.shape == (jcfg.img_size, jcfg.img_size)
    np.testing.assert_allclose(sal, sal_j, atol=ROLLOUT_TOL, rtol=0)
    assert 0.9 <= sal.max() <= 1.0 + 1e-5


def test_rollout_hybrid_without_token_learner_raises(tiny_cfg):
    cfg = port_cfg(tiny_cfg.replace(use_token_learner=False))
    model = HQAViT(cfg).eval()
    with pytest.raises(ValueError, match="TokenLearner"):
        attention_rollout(model, np.zeros((16, 16, 3), np.float32))


def test_taps_record_only_inside_record(tiny_cfg):
    """A forward outside ``taps.record`` collects nothing and gives the
    same logits as one inside, which collects a learner map a block."""
    _, _, model, img = _bundle(tiny_cfg)
    x = torch.from_numpy(img)[None]
    with torch.no_grad():
        with mock.patch.object(taps, "_RECORD", None):
            l0, _ = model(x)
        with taps.record() as rec:
            l1, _ = model(x)
    assert torch.equal(l0, l1) and taps._RECORD is None
    w = rec["token_learner.weights"]
    assert len(w) == tiny_cfg.depth and w[0].shape == (
        1, tiny_cfg.num_patches, tiny_cfg.num_learned_tokens)


def test_jet_matches_matplotlib():
    import matplotlib.cm as cm

    x = np.concatenate([np.linspace(0, 1, 20001, dtype=np.float32),
                        np.random.RandomState(0).rand(5000).astype(
                            np.float32)])
    np.testing.assert_array_equal(PNG.jet(x), cm.jet(x)[..., :3])
    np.testing.assert_array_equal((PNG.jet(x) * 255).astype(np.uint8),
                                  (cm.jet(x)[..., :3] * 255).astype(
                                      np.uint8))


def test_png_reads_back_pixel_exact(tmp_path):
    from PIL import Image

    rs = np.random.RandomState(3)
    cam = rs.rand(24, 20).astype(np.float32)
    img = rs.randint(0, 256, (24, 20, 3)).astype(np.uint8)
    heat_path, over_path = save_gradcam_overlay(cam, img,
                                                str(tmp_path / "g"))
    heat = np.asarray(Image.open(heat_path).convert("RGB"))
    over = np.asarray(Image.open(over_path).convert("RGB"))
    want = (PNG.jet(cam) * 255).astype(np.uint8)
    np.testing.assert_array_equal(heat, want)
    np.testing.assert_array_equal(
        over, (0.5 * want + 0.5 * img).astype(np.uint8))


@pytest.mark.parametrize("preset", ["hqavit_c100", "qavit_v2_c100"])
def test_cli_evaluate_gradcam_rollout_file_names(preset, tmp_path):
    """``cli.evaluate --synthetic --gradcam --rollout --device cpu`` at a
    depth-2 cut of the preset writes JAX's file names: Grad-CAM pairs under
    ``gradcam/``, rollout pairs beside it, named by the evaluation's
    predictions."""
    from qavit_tpu_torch.configs import presets as P

    base = P.PRESETS[preset]()
    cut = dataclasses.replace(base, model=base.model.replace(
        depth=2, stage_blocks=(1, 1, 0, 0) if base.model.hybrid else (2,)))
    with mock.patch.dict(P.PRESETS, {preset: lambda: cut}):
        r = cli_evaluate.main(["--preset", preset, "--synthetic",
                               "--device", "cpu", "--batch-size", "4",
                               "--batches", "1", "--gradcam",
                               "--gradcam-images", "2", "--rollout",
                               "--rollout-images", "3", "--out-dir",
                               str(tmp_path)])
    preds = r["logits"].argmax(-1)
    labels = r["labels"]
    names = sorted(p.name for p in (tmp_path / "gradcam").iterdir())
    assert len(names) == 4 and all(
        n.startswith("gradcam_") and n.endswith(("_heat.png",
                                                 "_overlay.png"))
        for n in names)
    for i in range(3):
        stem = f"rollout_{i}_pred{int(preds[i])}_true{int(labels[i])}"
        for kind in ("heat", "overlay"):
            assert (tmp_path / f"{stem}_{kind}.png").exists(), stem
    assert math.isfinite(r["loss"])
