"""Weight bridge, the port -> JAX direction: the inverse of
``ckpt/from_jax.py``.

A port model (its weights, BatchNorm statistics and bank rows) becomes
the JAX package's ``params`` / ``batch_stats`` trees, nested dicts of
float32 numpy arrays: the blocks of a stack (``stage{i}_blocks.{j}``,
the flat ``blocks.{j}``, at the top of the model or under a scope such as
SimCLRNet's ``HQAViT_0``) restacked on a leading ``nn.scan`` axis,
convolution kernels OIHW -> HWIO, BatchNorm ``weight`` / ``bias`` /
``running_mean`` / ``running_var`` to ``scale`` / ``bias`` (params) and
``mean`` / ``var`` (batch_stats); every other leaf keeps its name and
layout (Dense kernels are ``[in, out]`` on both sides).  With a train
state, also the EMA trees and the bank count, the keys
``from_jax.jax_train_state`` reads: JAX's forward and train step then
run from the port's weights.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from qavit_tpu_torch.ckpt.from_jax import _BN, _SCAN

_FROM_BN = {v: k for k, v in _BN.items()}     # weight -> scale, ...

Tree = Dict[str, Any]


def _jax_leaf(model: nn.Module, key: str, t: torch.Tensor
              ) -> Optional[Tuple[str, Tuple[str, ...], np.ndarray]]:
    """(collection, JAX path, array) of state-dict entry ``key``, None for
    an entry JAX does not keep (BatchNorm's ``num_batches_tracked``)."""
    prefix, _, leaf = key.rpartition(".")
    mod = model.get_submodule(prefix) if prefix else model
    a = t.detach().to("cpu", torch.float32).numpy()
    coll = "params"
    if isinstance(mod, nn.Conv2d) and leaf == "weight":
        leaf, a = "kernel", a.transpose(2, 3, 1, 0)
    elif isinstance(mod, nn.BatchNorm2d):
        if leaf not in _FROM_BN:
            return None
        leaf = _FROM_BN[leaf]
        if leaf in ("mean", "var"):
            coll = "batch_stats"
    return coll, tuple(prefix.split(".") if prefix else ()) + (leaf,), a


def _restack(path: Tuple[str, ...]) -> Tuple[Tuple[str, ...], Optional[int]]:
    """(path with a stack's block index removed, that index or None)."""
    for i, k in enumerate(path[:-1]):
        if _SCAN.match(k) and path[i + 1].isdigit():
            return path[:i + 1] + path[i + 2:], int(path[i + 1])
    return path, None


def _nest(flat: Dict[Tuple[str, ...], np.ndarray]) -> Tree:
    tree: Tree = {}
    for path, a in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = a
    return tree


def jax_trees(model: nn.Module,
              state_dict: Optional[Mapping[str, torch.Tensor]] = None
              ) -> Tuple[Tree, Tree]:
    """(params, batch_stats) of ``model`` in JAX's layout; with
    ``state_dict`` (the model's keys, e.g. its EMA), of those values."""
    sd = model.state_dict() if state_dict is None else state_dict
    stacks: Dict[Tuple[str, Tuple[str, ...]], Dict[int, np.ndarray]] = {}
    for key, t in sd.items():
        leaf = _jax_leaf(model, key, t)
        if leaf is None:
            continue
        coll, path, a = leaf
        path, idx = _restack(path)
        stacks.setdefault((coll, path), {})[-1 if idx is None else idx] = a
    flat: Dict[str, Dict[Tuple[str, ...], np.ndarray]] = {
        "params": {}, "batch_stats": {}}
    for (coll, path), parts in stacks.items():
        if list(parts) == [-1]:
            flat[coll][path] = parts[-1]
        else:
            flat[coll][path] = np.stack([parts[j] for j in sorted(parts)])
    return _nest(flat["params"]), _nest(flat["batch_stats"])


def jax_tree_of_state(state) -> Tree:
    """A port train state as the numpy tree ``from_jax.jax_train_state``
    takes (and JAX's checkpoint restore gives): ``params``,
    ``batch_stats``, ``bank_count`` and, where the state keeps an EMA,
    ``ema_params`` / ``ema_batch_stats``."""
    model = state.model
    params, stats = jax_trees(model)
    tree: Tree = {"params": params, "batch_stats": stats,
                  "bank_count": np.asarray(int(state.bank_count), np.int32)}
    if state.ema_params is not None:
        sd = dict(model.state_dict())
        sd.update(state.ema_params)
        sd.update(state.ema_buffers or {})
        tree["ema_params"], tree["ema_batch_stats"] = jax_trees(model, sd)
    return tree
