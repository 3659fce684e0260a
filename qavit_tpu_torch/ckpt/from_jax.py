"""Weight bridge: the JAX package's ``params`` / ``batch_stats`` trees into
the port's modules.

The trees are nested dicts of numpy arrays as ``qavit_tpu.nn.init_model``
or a restored checkpoint gives them.  Leaves map by path; on the way
the bridge
* unstacks the ``nn.scan`` leading axis of ``stage{i}_blocks`` (HQAViT)
  and ``blocks`` (the flat QAViT) into ``stage{i}_blocks.{j}`` and
  ``blocks.{j}``,
* transposes convolution kernels HWIO -> OIHW (``nn.Conv2d``),
* renames BatchNorm ``scale``/``bias``/``mean``/``var`` to
  ``weight``/``bias``/``running_mean``/``running_var``,
* keeps Dense kernels ``[in, out]``, the layout the port stores.
A JAX leaf the model lacks, a model entry the trees lack, or a shape
that disagrees raises.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

_SCAN = re.compile(r"(stage\d+_)?blocks$")
_BN = {"scale": "weight", "bias": "bias", "mean": "running_mean",
       "var": "running_var"}


def _leaves(tree: Mapping, path: Tuple[str, ...] = ()) -> Iterator:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, path + (str(k),))
        else:
            yield path + (str(k),), np.asarray(v)


def _unstack(path, arr) -> Iterator:
    if path and _SCAN.match(path[0]):
        for i in range(arr.shape[0]):
            yield (path[0], str(i)) + path[1:], arr[i]
    else:
        yield path, arr


def _torch_entry(model: nn.Module, path: Tuple[str, ...], arr: np.ndarray):
    prefix, leaf = ".".join(path[:-1]), path[-1]
    try:
        mod = model.get_submodule(prefix)
    except AttributeError:
        raise KeyError(f"extra leaf {'/'.join(path)}: the model has no "
                       f"module {prefix!r}") from None
    if isinstance(mod, nn.Conv2d) and leaf == "kernel":
        leaf, arr = "weight", arr.transpose(3, 2, 0, 1)
    elif isinstance(mod, nn.BatchNorm2d):
        leaf = _BN.get(leaf, leaf)
    return (f"{prefix}.{leaf}" if prefix else leaf), arr


def jax_state_dict(model: nn.Module, params: Mapping,
                   batch_stats: Optional[Mapping] = None
                   ) -> Dict[str, torch.Tensor]:
    """The model's state dict made from the JAX trees (checked for
    missing and extra leaves and for shapes)."""
    state = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    for tree in (params, batch_stats or {}):
        for path, arr in _leaves(tree):
            for p, a in _unstack(path, arr):
                key, a = _torch_entry(model, p, a)
                if key not in state:
                    raise KeyError(f"extra leaf {'/'.join(path)}: no "
                                   f"{key!r} in the model")
                if tuple(a.shape) != tuple(state[key].shape):
                    raise ValueError(f"{key}: JAX shape {a.shape} != port "
                                     f"shape {tuple(state[key].shape)}")
                out[key] = torch.from_numpy(np.array(a, np.float32,
                                                     order="C"))
    missing = [k for k in state
               if k not in out and not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"missing leaves for {len(missing)} model entries, "
                       f"e.g. {missing[:5]}")
    return out


def load_jax_params(model: nn.Module, params: Mapping,
                    batch_stats: Optional[Mapping] = None) -> nn.Module:
    """Copy the JAX trees into ``model`` in place and return it."""
    new = jax_state_dict(model, params, batch_stats)
    state = model.state_dict()
    with torch.no_grad():
        for key, val in new.items():
            state[key].copy_(val)
    return model
