"""Importer of the reference's PyTorch state dicts (counterpart of
``qavit_tpu/ckpt/torch_import.py``).

The reference checkpoints (HQAViT_CIFAR100.py / QAViT.py module layouts,
``module.`` / ``_orig_mod.`` prefixes, test_hqa.py:94-104) name their
tensors as the reference's modules do, not as the port's.  This module
keeps its own copy of the JAX package's name map and layout transforms
(numpy only): each leaf of the JAX tree (``to_jax.jax_trees`` of the
port's model gives the template) names its reference tensor and how to
lay it out, then ``from_jax.load_jax_params`` puts the tree into the
port's model.

Layout transforms:
* Linear ``[out, in]``            -> Dense kernel ``[in, out]`` (transpose)
* Conv2d ``[out, in, kh, kw]``    -> JAX kernel ``[kh, kw, in, out]``
* depthwise Conv2d ``[C,1,k,k]``  -> ``[k, k, 1, C]`` (same transpose)
* patch-embed conv                -> Dense kernel ``[(p*p*cin), C]`` in
  (ph, pw, cin) patch-vector order (``nn/layers.py`` PatchEmbed)
* LayerNorm/BatchNorm weight/bias -> scale/bias; running stats ->
  batch_stats mean/var
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch.nn as nn

from qavit_tpu_torch.ckpt.from_jax import load_jax_params
from qavit_tpu_torch.ckpt.to_jax import jax_trees

# JAX scope / leaf name -> the reference's module name fragments
_SEG_MAP = {
    "attn_norm": "attention.0",
    "attn_fc": "attention.1",
    "cat_fc": "cat_mlp.0",
    "cat_norm": "cat_mlp.1",
    "stem_conv": "stem.0",
    "stem_bn": "stem.1",
    "stage1_conv": "stage1.0",
    "stage1_bn": "stage1.1",
    "stage1_block": "stage1.3",
    "stage2_conv": "stage2.0",
    "stage2_bn": "stage2.1",
    "stage2_block": "stage2.2",
    "stage3_conv": "stage3.0",
    "stage3_bn": "stage3.1",
    "stage3_block": "stage3.2",
    "block0": "blocks.0",
    "block1": "blocks.1",
    "block2": "blocks.2",
    # the v2 ConvNeXt-patchify stem (HQAViTv2_CIFAR100.py:753-832)
    "stem_norm": "stem.1",
    "stage2_block0": "stage2.0",
    "stage2_block1": "stage2.1",
    "stage3_block0": "stage3.0",
    "stage3_block1": "stage3.1",
    "stage3_block2": "stage3.2",
    "stage4_block0": "stage4.0",
    "stage4_block1": "stage4.1",
    "down2_norm": "downsample2.0",
    "down2_conv": "downsample2.1",
    "down3_norm": "downsample3.0",
    "down3_conv": "downsample3.1",
}

# a Linear weight is always [out, in] in the reference and always
# transposed, square ones included (the bank's write_compression)
_BANK_MAP = {
    "write_norm_scale": ("write_norm.weight", "as_is"),
    "write_norm_bias": ("write_norm.bias", "as_is"),
    "write_compression_kernel": ("write_compression.weight", "dense_t"),
    "write_compression_bias": ("write_compression.bias", "as_is"),
    "write_gate_kernel": ("write_gate.weight", "dense_t"),
    "write_gate_bias": ("write_gate.bias", "as_is"),
}

Tree = Dict[str, Any]


def strip_prefixes(state_dict: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """Strip ``module.`` / ``_orig_mod.`` prefixes (test_hqa.py:94-104)."""
    out = {}
    for k, v in state_dict.items():
        for pre in ("module.", "_orig_mod."):
            if k.startswith(pre):
                k = k[len(pre):]
        out[k] = np.asarray(v.detach().cpu() if hasattr(v, "detach") else v)
    return out


def leaf_to_torch(path: Tuple[str, ...]) -> Tuple[str, str]:
    """A JAX param path (scope..., leaf) -> (reference key, layout kind)."""
    *scopes, leaf = path
    if scopes and scopes[0] == "global_bank" and leaf in _BANK_MAP:
        tkey, kind = _BANK_MAP[leaf]
        return "global_bank." + tkey, kind
    segs = [_SEG_MAP.get(s, s) for s in scopes]
    if leaf == "kernel":
        return ".".join(segs + ["weight"]), "kernel"
    if leaf == "scale" and segs and segs[-1] == "dwconv":
        # the stabilised DepthwiseConv2d's scale [1, C, 1, 1] -> [C]
        return ".".join(segs + ["scale"]), "reshape"
    if leaf == "scale":
        return ".".join(segs + ["weight"]), "as_is"
    if leaf == "bias":
        return ".".join(segs + ["bias"]), "as_is"
    if leaf in ("mean", "var"):
        return ".".join(segs + [f"running_{leaf}"]), "as_is"
    if leaf == "qkv_kernel":
        return ".".join(segs + ["qkv", "weight"]), "dense_t"
    if leaf == "qkv_bias":
        return ".".join(segs + ["qkv", "bias"]), "as_is"
    if leaf == "gamma" and segs and segs[-1] == "ccf_ffn":
        return ".".join(segs + ["gamma"]), "as_is"
    # plain parameter leaves (pos_embed, global_k, fusion_weights, beta,
    # E_k, E_v, gamma, scale ...)
    return ".".join(segs + [leaf]), "reshape"


def transform(tv: np.ndarray, target_shape, kind: str) -> np.ndarray:
    if kind == "kernel":
        if tv.ndim == 4:
            tv = tv.transpose(2, 3, 1, 0)          # conv OIHW -> HWIO
            if len(target_shape) == 2:             # patch embed as Dense
                tv = tv.reshape(-1, tv.shape[-1])
        elif tv.ndim == 2:
            tv = tv.T                              # Linear [out, in]
    elif kind == "dense_t":
        tv = tv.T
    if (kind == "as_is" and tv.ndim == 3 and len(target_shape) == 3
            and tuple(tv.shape) != tuple(target_shape)):
        # a spatial LayerNorm's affine: the reference's [C, H, W] -> [H, W, C]
        tv = tv.transpose(1, 2, 0)
    if tuple(tv.shape) != tuple(target_shape):
        tv = tv.reshape(target_shape)
    return tv


def _lookup(tdict, tpath, label) -> Tuple[np.ndarray, str]:
    tkey, kind = leaf_to_torch(tpath)
    if tkey not in tdict:
        raise KeyError(f"missing torch key {tkey!r} for {label}")
    return tdict[tkey], kind


def _convert(tree: Tree, tdict, path: Tuple[str, ...] = ()) -> Tree:
    out: Tree = {}
    for k, leaf in tree.items():
        keys = path + (k,)
        if isinstance(leaf, Mapping):
            out[k] = _convert(leaf, tdict, keys)
            continue
        shape, label = np.shape(leaf), "/".join(keys)
        if "blocks" in keys[0]:        # a scan stack: leading axis = depth
            per = []
            for j in range(shape[0]):
                tv, kind = _lookup(tdict, (f"{keys[0]}.{j}",) + keys[1:],
                                   label)
                per.append(transform(tv, shape[1:], kind))
            arr = np.stack(per)
        else:
            tv, kind = _lookup(tdict, keys, label)
            arr = transform(tv, shape, kind)
        out[k] = arr.astype(np.float32)
    return out


def import_torch_state_dict(state_dict: Mapping[str, Any], template_params,
                            template_batch_stats: Optional[Tree] = None):
    """A reference state dict -> (params, batch_stats) shaped as the JAX
    templates.  Raises KeyError naming a missing reference key."""
    tdict = strip_prefixes(state_dict)
    params = _convert(template_params, tdict)
    stats = (_convert(template_batch_stats, tdict)
             if template_batch_stats else None)
    return params, stats


def load_torch_state_dict(model: nn.Module,
                          state_dict: Mapping[str, Any]) -> nn.Module:
    """Put a reference state dict into the port's ``model`` (in place):
    the JAX tree of the model is the template, ``from_jax`` the last
    step."""
    params, stats = import_torch_state_dict(state_dict, *jax_trees(model))
    return load_jax_params(model, params, stats)
