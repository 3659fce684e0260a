"""The 96 px STL stage through the port against the JAX package:
``hqavit_tiny_proc_stl`` narrow (96 px, patch 4: 576 tokens taken down to
16 learned ones in each block) in eval and over 1 and 3 train steps at
dropout 0; LMFA's bilinear resize of a stem map off the token grid,
upsampled and downsampled, as a module and in a whole model; the 32 ->
96 px transfer (``load_for_transfer`` with the bicubic ``pos_embed``
resize) against JAX's on the same saved weights; and the presets.

Tolerances: float32, ``torch_port_common.F32`` (rtol 1e-4, atol 1e-5);
the steps, those of ``tests/torch_port_steps.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_steps as S
from qavit_tpu.ckpt import checkpoint as JC
from qavit_tpu.configs import get_preset as jax_get_preset
from qavit_tpu.configs.presets import PRESETS as JAX_PRESETS
from qavit_tpu.nn import hybrid as JH
from qavit_tpu_torch.ckpt import checkpoint as C
from qavit_tpu_torch.ckpt.from_jax import jax_state_dict, load_jax_params
from qavit_tpu_torch.configs import get_preset
from qavit_tpu_torch.configs.presets import PRESETS
from qavit_tpu_torch.nn import hybrid as H
from qavit_tpu_torch.nn.models import HQAViT
from qavit_tpu_torch.train.state import create_train_state
from torch_port_common import assert_close, jax_bundle, port_cfg, random_tree
from torch_port_common import one_thread  # noqa: F401 (autouse)

B = 2
NEW_PRESETS = ("hqavit_v2_c100", "hqavit_tiny_stl10", "hqavit_tiny_proc_stl",
               "simclr_stl10")


def narrow_stl(**kw):
    """hqavit_tiny_proc_stl at its token geometry (96 px, patch 4, 576
    patches, 16 learned tokens, 100 classes), narrow and shallow: C=48,
    depth 2, stem channels 8 / 12 / 16."""
    return jax_get_preset("hqavit_tiny_proc_stl").model.replace(
        embed_dim=48, depth=2, stage_blocks=(1, 1, 0, 0), linformer_k=8,
        cnn_c2=8, cnn_c3=12, cnn_c4=16, rrcv_channels=8, dtype="float32",
        attn_impl="fused_block", **kw)


def off_grid(patch):
    """hqavit_c100 narrow at 32 px with patch 2 (a 16 x 16 token grid:
    the stem's 8 x 8 maps are upsampled) or patch 8 (4 x 4: downsampled,
    antialiased)."""
    return jax_get_preset("hqavit_c100").model.replace(
        patch_size=patch, embed_dim=48, depth=2, stage_blocks=(1, 1, 0, 0),
        linformer_k=8, cnn_c2=8, cnn_c3=12, cnn_c4=16, rrcv_channels=8,
        dtype="float32", attn_impl="fused_block")


def _images(size, seed=1):
    return np.random.RandomState(seed).standard_normal(
        (B, size, size, 3)).astype(np.float32)


def _logits(jcfg, seed):
    jm, variables = jax_bundle(jcfg, seed=seed)
    x = _images(jcfg.img_size, seed + 1)
    ref = np.asarray(jm.apply(variables, jnp.asarray(x), train=False)[0])
    model = load_jax_params(HQAViT(port_cfg(jcfg)), variables["params"],
                            variables.get("batch_stats")).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x))[0]
    return got, ref


def test_stl96_eval_logits_match_jax():
    got, ref = _logits(narrow_stl(), 3)
    assert got.shape == (B, 100)
    assert_close(got, ref)


@pytest.mark.parametrize("patch", [2, 8])
def test_off_grid_model_logits_match_jax(patch):
    """A whole model whose stem maps (8 x 8) are off its token grid."""
    got, ref = _logits(off_grid(patch), 5)
    assert_close(got, ref)


@pytest.mark.parametrize("hw, target", [(8, 16), (8, 4), (6, 9), (12, 5)])
def test_lmfa_resize_matches_flax(hw, target):
    """LMFAdapter alone: the map resampled to the token grid, upsampled
    and downsampled (JAX antialiases when it downsamples)."""
    x = np.random.RandomState(hw).standard_normal(
        (B, hw, hw, 12)).astype(np.float32)
    fm = JH.LMFAdapter(32, target, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: fm.init(jax.random.PRNGKey(0),
                                            jnp.asarray(x)))
    params = random_tree(shapes["params"], np.random.RandomState(target))
    ref = fm.apply({"params": params}, jnp.asarray(x))
    port = load_jax_params(H.LMFAdapter(12, 32, target), params)
    got = port(torch.from_numpy(x), torch.float32)
    assert tuple(got.shape) == (B, target * target, 32)
    assert_close(got, ref)


@pytest.fixture(scope="module")
def stl_steps():
    return S.run_case("differential", narrow_stl())


@pytest.mark.parametrize("steps", [1, 3])
def test_stl96_train_steps_match_jax(stl_steps, steps):
    """The preset's recipe (cosine, differential LR groups, head x10) at
    dropout 0: losses, gradient norms, parameters, moments, EMA, the bank
    count and the BatchNorm statistics."""
    S.check_case(stl_steps, steps)


@pytest.mark.parametrize("drop_head", [True, "auto"])
def test_transfer_32_to_96_matches_jax(tmp_path, monkeypatch, capsys,
                                       drop_head):
    """A 32 px checkpoint's weights into the 96 px model: ``pos_embed``
    resized 8 -> 24 bicubically, every entry of another shape left at
    the model's own value, the head by the drop rule, BatchNorm merged;
    against JAX's ``load_for_transfer`` on the same weights (its orbax
    read replaced by the same numpy trees), the printed line included."""
    src_cfg = narrow_stl(img_size=32)
    dst_cfg = narrow_stl()
    _, src = jax_bundle(src_cfg, seed=11)
    _, dst = jax_bundle(dst_cfg, seed=12)
    monkeypatch.setattr(JC, "_restore_numpy", lambda _: dict(src))
    jp, jb = JC.load_for_transfer(str(tmp_path / "src"), dst["params"],
                                  drop_head=drop_head,
                                  template_batch_stats=dst["batch_stats"])
    ref_log = capsys.readouterr().out
    assert "grid 8 -> 24" in ref_log

    src_model = load_jax_params(HQAViT(port_cfg(src_cfg)), src["params"],
                                src["batch_stats"])
    C.save_train_state(tmp_path / "src", create_train_state(src_model,
                                                            False))
    model = load_jax_params(HQAViT(port_cfg(dst_cfg)), dst["params"],
                            dst["batch_stats"])
    C.load_for_transfer(tmp_path / "src", model, drop_head=drop_head)
    # the port also reports the BatchNorm buffers it merged
    assert capsys.readouterr().out.startswith(ref_log)
    want = jax_state_dict(model, jax.device_get(jp), jax.device_get(jb))
    got = model.state_dict()
    for k, v in want.items():
        assert_close(got[k], v.numpy(), err_msg=k)
    own = torch.from_numpy(np.asarray(dst["params"]["pos_embed"]))
    assert got["pos_embed"].shape == (1, 576, 48)
    assert not torch.allclose(got["pos_embed"], own)     # resized, not kept


@pytest.mark.parametrize("name", NEW_PRESETS)
def test_preset_matches_jax(name):
    pj, pt = jax_get_preset(name), get_preset(name)
    assert dataclasses.asdict(pt.model) == dataclasses.asdict(pj.model)
    assert dataclasses.asdict(pt.train) == dataclasses.asdict(pj.train)
    assert pt.dataset == pj.dataset


def test_every_jax_preset_is_defined():
    assert sorted(PRESETS) == sorted(JAX_PRESETS)
