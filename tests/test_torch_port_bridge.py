"""The weight bridge (qavit_tpu_torch/ckpt/from_jax.py): every leaf of the
full hqavit_c100 JAX tree maps onto the port's model, layouts are
converted, and a missing, extra or misshapen leaf raises."""

import copy

import numpy as np
import pytest
import torch

from qavit_tpu.configs import get_preset as jax_get_preset
from qavit_tpu_torch.ckpt.from_jax import jax_state_dict, load_jax_params
from qavit_tpu_torch.nn.models import HQAViT
from torch_port_common import jax_bundle, port_cfg


@pytest.fixture(scope="module")
def flagship():
    """The full-width, full-depth flagship tree (as init_model makes it,
    shapes via eval_shape) with seed-made values, and the port's model."""
    jcfg = jax_get_preset("hqavit_c100").model.replace(
        attn_impl="fused_block")
    _, variables = jax_bundle(jcfg, seed=3)
    return variables, HQAViT(port_cfg(jcfg))


def _count_leaves(tree):
    if isinstance(tree, dict):
        return sum(_count_leaves(v) for v in tree.values())
    return 1


def test_every_flagship_leaf_maps(flagship):
    variables, model = flagship
    sd = jax_state_dict(model, variables["params"], variables["batch_stats"])
    state = model.state_dict()
    entries = [k for k in state if not k.endswith("num_batches_tracked")]
    assert sorted(sd) == sorted(entries)
    # scanned stages unstack: 4 stages x 2 blocks
    blocks = {k.split(".quad_block")[0] for k in sd if ".quad_block." in k}
    assert len(blocks) == 8
    n_scanned = _count_leaves({k: v for k, v in variables["params"].items()
                               if k.startswith("stage")})
    n_flat = _count_leaves(variables["params"]) - n_scanned
    assert len(sd) == (n_flat + 2 * n_scanned
                       + _count_leaves(variables["batch_stats"]))


def test_layouts_convert(flagship):
    variables, model = flagship
    p, bs = variables["params"], variables["batch_stats"]
    sd = jax_state_dict(model, p, bs)
    # Dense stays [in, out]; the scan axis becomes the list index
    np.testing.assert_array_equal(
        sd["stage3_blocks.1.quad_block.swa.qkv.kernel"].numpy(),
        p["stage3_blocks"]["quad_block"]["swa"]["qkv"]["kernel"][1])
    # convs HWIO -> OIHW, the depthwise ones included
    np.testing.assert_array_equal(
        sd["cnn_stem.stem_conv.weight"].numpy(),
        p["cnn_stem"]["stem_conv"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        sd["stage2_blocks.0.quad_block.ccf_ffn.dwconv.dwconv.weight"]
        .numpy()[:, 0],
        p["stage2_blocks"]["quad_block"]["ccf_ffn"]["dwconv"]["dwconv"]
        ["kernel"][0][:, :, 0].transpose(2, 0, 1))
    # BatchNorm names
    np.testing.assert_array_equal(sd["cnn_stem.stem_bn.running_var"].numpy(),
                                  bs["cnn_stem"]["stem_bn"]["var"])
    np.testing.assert_array_equal(sd["cnn_stem.stem_bn.weight"].numpy(),
                                  p["cnn_stem"]["stem_bn"]["scale"])
    assert sd["rrcv2.beta"].shape == ()
    load_jax_params(model, p, bs)
    assert torch.equal(model.global_bank.global_k.detach(),
                       torch.from_numpy(p["global_bank"]["global_k"]))


def test_missing_leaf_raises(flagship):
    variables, model = flagship
    p = copy.deepcopy(variables["params"])
    del p["stage4_blocks"]["quad_block"]["cga"]["proj"]["bias"]
    with pytest.raises(KeyError, match="missing"):
        load_jax_params(model, p, variables["batch_stats"])
    with pytest.raises(KeyError, match="missing"):
        load_jax_params(model, variables["params"], None)


def test_extra_leaf_raises(flagship):
    variables, model = flagship
    p = copy.deepcopy(variables["params"])
    p["head"]["extra"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="extra leaf"):
        load_jax_params(model, p, variables["batch_stats"])
    p = copy.deepcopy(variables["params"])
    p["qavit_only_module"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError, match="extra leaf"):
        load_jax_params(model, p, variables["batch_stats"])


def test_shape_mismatch_raises(flagship):
    variables, model = flagship
    p = copy.deepcopy(variables["params"])
    p["head"]["kernel"] = np.zeros((192, 10), np.float32)
    with pytest.raises(ValueError, match="head.kernel"):
        load_jax_params(model, p, variables["batch_stats"])
