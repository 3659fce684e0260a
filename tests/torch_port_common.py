"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: configs in both packages, seed-made weights for a JAX tree
shape, and conversions between the two frameworks (numpy in between)."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from qavit_tpu.configs import get_preset as jax_get_preset
from qavit_tpu.nn import build_model as jax_build_model
from qavit_tpu_torch.configs.model import BankConfig, ModelConfig

# stated tolerances: float32 compares the algorithm (~1e-4 relative, the
# JAX package's own fused-vs-reference bound); bf16 allows two bf16 ulps
# of the largest output (2**-6 relative to max|ref|)
F32 = dict(rtol=1e-4, atol=1e-5)
BF16_REL_TO_MAX = 2.0 ** -6


def flagship_width_depth2():
    """hqavit_c100 at full width (C=192, 4 heads, 16 learned tokens) with
    depth cut to 2 (one block in each of the first two stages), fp32."""
    return jax_get_preset("hqavit_c100").model.replace(
        depth=2, stage_blocks=(1, 1, 0, 0), dtype="float32",
        attn_impl="fused_block")


def port_cfg(jcfg) -> ModelConfig:
    """The port's ModelConfig with the same field values."""
    d = dataclasses.asdict(jcfg)
    d["bank"] = BankConfig(**d["bank"])
    return ModelConfig(**d)


def random_tree(shapes, rs: np.random.RandomState, name: str = ""):
    """Seed-made float32 values for every leaf of a tree of shapes, scaled
    so activations stay O(1): kernels ~ N(0, 1/fan_in), LN/BN scales
    near 1, BN variances in [0.5, 1.5], everything else ~ 0.1 N(0, 1)."""
    if isinstance(shapes, dict):
        return {k: random_tree(v, rs, k) for k, v in shapes.items()}
    shape = tuple(shapes.shape)
    if name == "var":
        a = rs.uniform(0.5, 1.5, shape)
    elif name == "scale":
        a = 1.0 + 0.1 * rs.standard_normal(shape)
    elif name.endswith("kernel") or name in ("E_k", "E_v"):
        a = rs.standard_normal(shape) / np.sqrt(max(shape[-2], 1))
    else:
        a = 0.1 * rs.standard_normal(shape)
    return a.astype(np.float32)


def jax_bundle(jcfg, seed: int = 0, batch: int = 2):
    """(flax model, variables) with seed-made weights for the JAX tree of
    ``jcfg`` (shapes from ``eval_shape``, so nothing is compiled)."""
    model = jax_build_model(jcfg)
    dummy = jnp.zeros((batch, jcfg.img_size, jcfg.img_size,
                       jcfg.in_channels))
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        dummy, train=True))
    rs = np.random.RandomState(seed)
    variables = {"params": random_tree(shapes["params"], rs)}
    if "batch_stats" in shapes:          # the flat QAViT has no BatchNorm
        variables["batch_stats"] = random_tree(shapes["batch_stats"], rs)
    return model, variables


def block_tree(variables, stage: int = 1):
    """One QuadAttentionBlock's params (scan axis removed)."""
    sub = variables["params"][f"stage{stage}_blocks"]["quad_block"]
    return jax.tree_util.tree_map(lambda a: a[0], sub)


def to_np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(a).astype(np.float32)


def assert_close(port, ref, dtype=torch.float32, err_msg=""):
    """Port output against the JAX output with the stated tolerance."""
    p, r = to_np(port), to_np(ref)
    assert p.shape == r.shape, (p.shape, r.shape)
    assert np.isfinite(p).all() and np.isfinite(r).all()
    if dtype == torch.float32:
        np.testing.assert_allclose(p, r, err_msg=err_msg, **F32)
    else:
        bound = BF16_REL_TO_MAX * np.abs(r).max()
        assert np.abs(p - r).max() <= bound, (np.abs(p - r).max(), bound)
