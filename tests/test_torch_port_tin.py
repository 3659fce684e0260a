"""The depth-12 HQAViT at 64 px (``hqavit_tiny_in``, ``hqavit_proc_tin``:
64 learned tokens on an 8x8 grid, four SWA windows) through the port
against the JAX package: the eval logits of a narrow, shallow model at the
same token geometry in float32; the bf16 logits of it and of hqavit_c100
at full width and depth 2, held relative to JAX's own bf16-vs-float32
distance; the presets, the dataset statistics and the synthetic sets; the
weight bridge on the full 12-block tree; the entry points on the CPU,
and the train step's refusal (the n=64 backward kernels come next)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from qavit_tpu.configs import get_preset as jax_get_preset
from qavit_tpu.nn import build_model as jax_build_model
from qavit_tpu_torch.ckpt.from_jax import jax_state_dict, load_jax_params
from qavit_tpu_torch.configs import get_preset
from qavit_tpu_torch.kernels import fused_kernels as K
from qavit_tpu_torch.nn.models import HQAViT
from torch_port_common import (BF16_VS_F32, BF16_VS_JAX, assert_close,
                               flagship_width_depth2, jax_bundle,
                               narrow_tiny_in, port_cfg, to_np)

TIN_PRESETS = ("hqavit_tiny_in", "hqavit_proc_tin")
B = 2


def _jax_logits(jcfg, variables, x):
    jm = jax_build_model(jcfg)
    return np.asarray(jax.jit(lambda v, x: jm.apply(
        v, x, train=False, bank_count=0)[0])(variables, x))


def _port_logits(jcfg, variables, x):
    model = load_jax_params(HQAViT(port_cfg(jcfg)), variables["params"],
                            variables["batch_stats"]).eval()
    before = dict(K.LAUNCHES)
    with torch.no_grad():
        logits, _ = model(torch.from_numpy(x))
    assert K.LAUNCHES == before, "plain CPU runs must not count launches"
    return logits


CONFIGS = {"tiny_in_narrow": narrow_tiny_in,
           "c100_depth2": flagship_width_depth2}


@pytest.fixture(scope="module")
def cases():
    """which -> (float32 JAX config, variables, images, JAX float32
    logits), made on first use."""
    made = {}

    def get(which):
        if which not in made:
            jcfg = CONFIGS[which]()
            _, variables = jax_bundle(jcfg, seed=7)
            x = np.random.RandomState(8).standard_normal(
                (B, jcfg.img_size, jcfg.img_size, 3)).astype(np.float32)
            made[which] = (jcfg, variables, x,
                           _jax_logits(jcfg, variables, x))
        return made[which]

    return get


def test_tiny_in_eval_logits_match_jax(cases):
    jcfg, variables, x, lj = cases("tiny_in_narrow")
    lt = _port_logits(jcfg, variables, x)
    assert lt.dtype == torch.float32 and lt.shape == (B, 200)
    assert_close(lt, lj)


@pytest.mark.parametrize("which", list(CONFIGS))
def test_bf16_logits_within_jax_own_bf16_distance(cases, which):
    """bf16 logits relative to JAX's own bf16-vs-float32 distance on the
    same weights and images (ROADMAP queue 3 item 3), for the narrow
    hqavit_tiny_in and for hqavit_c100 at full width, depth 2."""
    jcfg, variables, x, lj32 = cases(which)
    jcfg16 = jcfg.replace(dtype="bfloat16")
    lj16 = _jax_logits(jcfg16, variables, x)
    lt16 = to_np(_port_logits(jcfg16, variables, x))
    scale = np.abs(lj32).max()
    jax_own = np.abs(lj16 - lj32).max() / scale
    vs_jax = np.abs(lt16 - lj16).max() / scale
    vs_f32 = np.abs(lt16 - lj32).max() / scale
    assert np.isfinite(lt16).all() and jax_own > 0
    assert vs_jax <= BF16_VS_JAX * jax_own, (vs_jax, jax_own)
    assert vs_f32 <= BF16_VS_F32 * jax_own, (vs_f32, jax_own)


@pytest.mark.parametrize("name", TIN_PRESETS)
def test_preset_matches_jax(name):
    pj, pt = jax_get_preset(name), get_preset(name)
    assert dataclasses.asdict(pt.model) == dataclasses.asdict(pj.model)
    assert dataclasses.asdict(pt.train) == dataclasses.asdict(pj.train)
    assert pt.dataset == pj.dataset


@pytest.mark.parametrize("name", ("tiny_imagenet", "proc_tin"))
def test_dataset_matches_jax(name):
    """Normalisation statistics of the pipeline and the synthetic set
    (64 px, 200 classes)."""
    from qavit_tpu.data import get_pipeline
    from qavit_tpu.data.datasets import _synthetic
    from qavit_tpu_torch.data.datasets import synthetic_dataset
    from qavit_tpu_torch.data.pipelines import get_pipeline as port_pipeline

    aug = get_pipeline(name).aug
    mean, std = port_pipeline(name).aug.mean, port_pipeline(name).aug.std
    assert (tuple(mean), tuple(std)) == (tuple(aug.mean), tuple(aug.std))
    dj, dt = _synthetic(name, 64, 200), synthetic_dataset(name, 64, 200)
    for a in ("train_images", "train_labels", "test_images", "test_labels"):
        np.testing.assert_array_equal(getattr(dt, a), getattr(dj, a))


def test_bridge_loads_the_full_tree():
    """Every leaf of hqavit_tiny_in's JAX tree maps, none is missing, and
    the 6-block stage 3 scan axis unstacks into stage3_blocks.0-5."""
    jcfg = jax_get_preset("hqavit_tiny_in").model
    _, variables = jax_bundle(jcfg, seed=3)
    sd = jax_state_dict(HQAViT(port_cfg(jcfg)), variables["params"],
                        variables["batch_stats"])
    blocks = {k.split(".")[0]: set() for k in sd if "_blocks." in k}
    for k in sd:
        if "_blocks." in k:
            blocks[k.split(".")[0]].add(int(k.split(".")[1]))
    assert blocks == {"stage1_blocks": {0, 1}, "stage2_blocks": {0, 1},
                      "stage3_blocks": set(range(6)),
                      "stage4_blocks": {0, 1}}
    e = variables["params"]["stage3_blocks"]["quad_block"]["swa"]["qkv"][
        "kernel"]
    np.testing.assert_array_equal(
        sd["stage3_blocks.5.quad_block.swa.qkv.kernel"].numpy(), e[5])


def test_model_structure():
    """[2, 2, 6, 2] blocks; each TokenLearner takes 256 tokens to 64 and
    each TokenUpMix 64 back to 256; every block has the n=64 geometry."""
    model = HQAViT(get_preset("hqavit_proc_tin").model)
    counts = [len(getattr(model, f"stage{i}_blocks")) for i in (1, 2, 3, 4)]
    assert counts == [2, 2, 6, 2] and model.stages == [1, 2, 3, 4]
    for i in (1, 2, 3, 4):
        for blk in getattr(model, f"stage{i}_blocks"):
            assert blk.token_learner.attn_fc.kernel.shape == (192, 64)
            assert blk.token_upmix.upsample_attn.kernel.shape == (64, 256)
            g = blk.quad_block.geom
            assert (g.n, g.nw, g.ws2, g.msda_keep) == (64, 4, 16, 40)


def test_cli_evaluate_on_cpu():
    from qavit_tpu_torch.cli import evaluate

    before = dict(K.LAUNCHES)
    r = evaluate.main(["--preset", "hqavit_proc_tin", "--synthetic",
                       "--batch-size", "2", "--batches", "1",
                       "--device", "cpu"])
    assert r["count"] == 2 and r["device"] == "cpu"
    assert np.isfinite(r["loss"]) and r["img_per_s"] > 0
    assert K.LAUNCHES == before


@pytest.mark.parametrize("name", TIN_PRESETS)
def test_train_step_refused_before_the_first_step(name):
    """The n=64 train step is ported: make_train_step builds it and bench
    --train runs it on the CPU at full depth through the plain units (no
    kernel launch), with finite losses."""
    from qavit_tpu_torch.cli import bench
    from qavit_tpu_torch.train.steps import make_train_step

    preset = get_preset(name)
    assert callable(make_train_step(preset.model, preset.train,
                                    lambda s: 0.0))
    before = dict(K.LAUNCHES)
    rows = bench.main(["--preset", name, "--train", "--batch-sizes", "2",
                       "--steps", "1", "--device", "cpu"])
    assert K.LAUNCHES == before
    assert len(rows) == 1 and rows[0]["batch"] == 2, rows
    assert np.isfinite(rows[0]["first_loss"]), rows
