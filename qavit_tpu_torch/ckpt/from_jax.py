"""Weight bridge: the JAX package's ``params`` / ``batch_stats`` trees into
the port's modules.

The trees are nested dicts of numpy arrays as ``qavit_tpu.nn.init_model``
or a restored checkpoint gives them.  Leaves map by path; on the way
the bridge
* unstacks the ``nn.scan`` leading axis of ``stage{i}_blocks`` (HQAViT)
  and ``blocks`` (the flat QAViT) into ``stage{i}_blocks.{j}`` and
  ``blocks.{j}``, at the top of the tree or under a scope (SimCLRNet's
  ``HQAViT_0`` / ``QAViT_0``),
* transposes convolution kernels HWIO -> OIHW (``nn.Conv2d``),
* renames BatchNorm ``scale``/``bias``/``mean``/``var`` to
  ``weight``/``bias``/``running_mean``/``running_var``,
* keeps Dense kernels ``[in, out]``, the layout the port stores.
The v2 stem's SpatialLayerNorm ``scale`` / ``bias`` ([H, W, C]), the
LayerScale ``gamma`` and SimCLR's ``proj_fc1`` / ``proj_fc2`` map as they
are.  A JAX leaf the model lacks, a model entry the trees lack, or a
shape that disagrees raises.
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
    at = next((i for i, k in enumerate(path[:-1]) if _SCAN.match(k)), None)
    if at is None:
        yield path, arr
    else:
        for i in range(arr.shape[0]):
            yield path[:at + 1] + (str(i),) + path[at + 1:], arr[i]


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


def jax_train_state(model: nn.Module, tree: Mapping, use_ema: bool = True):
    """A port train state made from a JAX checkpoint's numpy trees (as
    ``qavit_tpu.ckpt.checkpoint._restore_numpy`` gives them): the
    weights, the BatchNorm statistics, the EMA where the tree has one
    (else the EMA starts from the weights) and the bank count.  The
    optimizer state and step stay fresh, so save the result with
    ``save_train_state(..., slim=True)``: it seeds an evaluation, a
    finetune or a transfer, not a resume."""
    from qavit_tpu_torch.train.state import create_train_state

    load_jax_params(model, tree["params"], tree.get("batch_stats"))
    state = create_train_state(model, use_ema)
    if use_ema and "ema_params" in tree:
        ema = jax_state_dict(model, tree["ema_params"],
                             tree.get("ema_batch_stats")
                             or tree.get("batch_stats"))
        dev = state.bank_count.device
        with torch.no_grad():
            for n in state.ema_params:
                state.ema_params[n].copy_(ema[n].to(dev))
            for n in state.ema_buffers:
                if n in ema:
                    state.ema_buffers[n].copy_(ema[n].to(dev))
    state.bank_count = torch.as_tensor(
        np.asarray(tree.get("bank_count", 0)), dtype=torch.int32,
        device=state.bank_count.device)
    return state
