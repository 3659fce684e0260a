"""Checkpoints of the port's train state with true step-level resume
(counterpart of ``qavit_tpu/ckpt/checkpoint.py``).

A checkpoint is a directory holding ``state.pt`` and ``meta.json``.
``state.pt`` is one ``torch.save`` file of plain tensors, ints and floats,
read back with ``torch.load(..., weights_only=True)``:

* ``step``: the optimizer steps taken;
* ``params``: every parameter by its ``named_parameters`` name, the bank's
  ``global_k`` / ``global_v`` included;
* ``batch_stats``: every buffer (the BatchNorm running statistics);
* ``opt_state``: Adam's ``count`` and its moments ``mu`` / ``nu`` by
  parameter name;
* ``bank_count``, ``ema_decay``, and with an EMA ``ema_params`` /
  ``ema_batch_stats``.

``meta.json`` has the JAX package's keys: ``metrics``, ``state_keys``,
``model_config``, ``train_config``.  Each file is written under a
temporary name in the same directory and moved into place with
``os.replace``, ``meta.json`` last, so a run stopped during a save
leaves either the old file or the new one, never part of one.

The JAX package's checkpoints are orbax directories (``<dir>/state/``),
which only JAX reads.  :func:`restore_train_state` refuses one and names
the way across: on a host with JAX, ``_restore_numpy`` gives numpy trees,
``ckpt/from_jax.py`` ``jax_train_state`` makes a port train state of
them, and :func:`save_train_state` with ``slim=True`` writes it.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn

from qavit_tpu_torch.configs.model import ModelConfig
from qavit_tpu_torch.configs.training import TrainingConfig
from qavit_tpu_torch.train.optim import AdamState
from qavit_tpu_torch.train.state import TrainState

STATE_FILE = "state.pt"
META_FILE = "meta.json"
# what a slim checkpoint keeps (retain_checkpoint): the weights, no
# optimizer state, step or EMA decay
SLIM_KEYS = ("params", "batch_stats", "ema_params", "ema_batch_stats",
             "bank_count")


def state_tree(state: TrainState) -> Dict[str, Any]:
    """The train state as the dict ``state.pt`` holds."""
    named = dict(state.model.named_parameters())
    tree = {
        "step": int(state.step),
        "params": {n: named[n].detach() for n in state.names},
        "opt_state": {"count": int(state.opt.count),
                      "mu": dict(zip(state.names, state.opt.mu)),
                      "nu": dict(zip(state.names, state.opt.nu))},
        "batch_stats": {n: b.detach()
                        for n, b in state.model.named_buffers()},
        "bank_count": state.bank_count.detach(),
        "ema_decay": float(state.ema_decay),
    }
    if state.ema_params is not None:
        tree["ema_params"] = dict(state.ema_params)
        tree["ema_batch_stats"] = dict(state.ema_buffers)
    return tree


def _replace_into(dst: Path, write: Callable) -> int:
    """Write ``dst`` through a temporary file in its directory and
    ``os.replace``; returns the bytes written."""
    fd, tmp = tempfile.mkstemp(dir=dst.parent, prefix=f".{dst.name}.",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            write(f)
            f.flush()
            os.fsync(f.fileno())
            size = f.tell()
        os.replace(tmp, dst)
    except BaseException:
        with contextlib.suppress(FileNotFoundError):
            os.unlink(tmp)
        raise
    return size


def _write(path: Path, tree: Dict[str, Any], meta: Dict[str, Any]) -> int:
    path.mkdir(parents=True, exist_ok=True)
    size = _replace_into(path / STATE_FILE, lambda f: torch.save(tree, f))
    meta = dict(meta, state_keys=sorted(tree))
    text = json.dumps(meta, indent=2).encode()
    return size + _replace_into(path / META_FILE, lambda f: f.write(text))


def save_train_state(path, state: TrainState,
                     model_config: Optional[ModelConfig] = None,
                     train_config: Optional[TrainingConfig] = None,
                     metrics: Optional[Dict[str, float]] = None,
                     slim: bool = False) -> int:
    """Save a checkpoint of ``state`` (``slim``: the weights only, as
    :func:`retain_checkpoint` keeps them) with the configs beside it;
    returns the bytes written."""
    tree = state_tree(state)
    if slim:
        tree = {k: tree[k] for k in SLIM_KEYS if k in tree}
    meta: Dict[str, Any] = {"metrics": metrics or {}}
    if model_config is not None:
        meta["model_config"] = model_config.to_dict()
    if train_config is not None:
        meta["train_config"] = train_config.to_dict()
    return _write(Path(path), tree, meta)


def _load(path, device) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    path = Path(path)
    if not (path / STATE_FILE).exists():
        if (path / "state").is_dir():
            raise ValueError(
                f"{path} is an orbax checkpoint of the JAX package, which "
                f"the port does not read.  Convert it on a host with JAX: "
                f"qavit_tpu.ckpt.checkpoint._restore_numpy(<dir>/state) "
                f"gives numpy trees, qavit_tpu_torch.ckpt.from_jax."
                f"jax_train_state makes a port train state of them, and "
                f"qavit_tpu_torch.ckpt.checkpoint.save_train_state(..., "
                f"slim=True) writes it (README, the port's section)")
        raise FileNotFoundError(f"no checkpoint at {path} (no {STATE_FILE})")
    if not (path / META_FILE).exists():
        raise FileNotFoundError(f"{path} has no {META_FILE}: its save did "
                                f"not finish")
    meta = json.loads((path / META_FILE).read_text())
    tree = torch.load(path / STATE_FILE, map_location=device,
                      weights_only=True)
    return tree, meta


@torch.no_grad()
def _copy_named(dst: Dict[str, torch.Tensor], src: Dict[str, torch.Tensor],
                what: str) -> None:
    missing = sorted(set(dst) - set(src))
    extra = sorted(set(src) - set(dst))
    if missing or extra:
        raise KeyError(f"checkpoint {what}: missing {missing[:5]}, extra "
                       f"{extra[:5]} against the model")
    for n, t in dst.items():
        if tuple(t.shape) != tuple(src[n].shape):
            raise ValueError(f"checkpoint {what} {n}: shape "
                             f"{tuple(src[n].shape)}, the model's "
                             f"{tuple(t.shape)}")
        t.copy_(src[n])


def restore_train_state(path, template: TrainState
                        ) -> Tuple[TrainState, Dict[str, Any]]:
    """Restore a checkpoint into ``template`` (in place) and return it
    with the meta.  JAX's rules (``checkpoint.py:62-120``): a with-EMA
    checkpoint loads into a no-EMA template and vice versa (a no-EMA
    checkpoint starts the template's EMA from its weights), and a slim
    checkpoint keeps the template's optimizer state, step and EMA
    decay."""
    dev = template.bank_count.device
    tree, meta = _load(path, dev)
    model = template.model
    _copy_named(dict(model.named_parameters()), tree["params"], "params")
    _copy_named(dict(model.named_buffers()), tree["batch_stats"],
                "batch_stats")
    template.step = int(tree.get("step", template.step))
    if "opt_state" in tree:
        opt = tree["opt_state"]
        template.opt = AdamState(int(opt["count"]),
                                 [opt["mu"][n] for n in template.names],
                                 [opt["nu"][n] for n in template.names])
    template.bank_count = tree["bank_count"].to(dev, torch.int32)
    template.ema_decay = float(tree.get("ema_decay", template.ema_decay))
    if template.ema_params is not None:
        src = tree.get("ema_params", tree["params"])
        _copy_named(template.ema_params, src, "ema_params")
        src = tree.get("ema_batch_stats", tree["batch_stats"])
        _copy_named(template.ema_buffers, src, "ema_batch_stats")
    return template, meta


def load_for_transfer(path, model: nn.Module, drop_head="auto",
                      use_ema: bool = False, simclr: bool = False
                      ) -> nn.Module:
    """Load a checkpoint's weights into ``model`` for finetuning
    (``checkpoint.py:142-253``): entries whose name and shape match are
    copied, the rest keep the model's values.

    ``drop_head`` is True / False / "auto": "auto" keeps the head exactly
    when its shapes match the model's (a same-task finetune), True always
    keeps the model's own head (a new task).  ``use_ema`` starts from the
    checkpoint's EMA weights where it has them.  The BatchNorm running
    statistics are merged too (the EMA's with ``use_ema``).  A
    position embedding of another grid and ``simclr`` raise: their paths
    are not ported."""
    if simclr:
        raise NotImplementedError(
            "a SimCLR checkpoint's backbone is not ported yet (ROADMAP.md "
            "queue 1 item 8)")
    tree, _ = _load(path, next(model.parameters()).device)
    params = tree["params"]
    if use_ema:
        if "ema_params" in tree:
            params = tree["ema_params"]
            print("transfer: using EMA weights as the starting params")
        else:
            print("transfer: --init-ema requested but checkpoint has no "
                  "ema_params; falling back to raw params")
    named = dict(model.named_parameters())
    if drop_head == "auto":
        def heads(d):
            return {n: tuple(v.shape) for n, v in d.items()
                    if n.startswith("head")}
        src_head, dst_head = heads(params), heads(named)
        drop_head = src_head != dst_head
        if not drop_head and src_head:
            print("transfer: same-task head shapes match — head kept "
                  "(HQAViT_C100_Finetune.py:404-408 semantics)")
    with torch.no_grad():
        for n, v in params.items():
            if n not in named or (drop_head and n.startswith("head")):
                continue
            if n == "pos_embed" and v.shape != named[n].shape:
                raise NotImplementedError(
                    f"transfer: pos_embed {tuple(v.shape)} -> "
                    f"{tuple(named[n].shape)} needs the bicubic resize, "
                    f"not ported yet (ROADMAP.md queue 1 item 7, "
                    f"resize_pos_embed)")
            if v.shape == named[n].shape:
                named[n].copy_(v)
        src = ((tree.get("ema_batch_stats") if use_ema else None)
               or tree.get("batch_stats") or {})
        for n, b in model.named_buffers():
            if n in src and src[n].shape == b.shape:
                b.copy_(src[n])
    return model


def retain_checkpoint(src, dst) -> int:
    """Export a slim copy of a checkpoint: the weights only
    ({params, batch_stats, ema_params, ema_batch_stats, bank_count}), no
    optimizer state or step, so it seeds a finetune, a transfer or an
    evaluation but not a ``--resume`` (``checkpoint.py:256-281``).
    Returns the bytes written."""
    src_p, dst_p = Path(src).resolve(), Path(dst).resolve()
    tree, meta = _load(src_p, "cpu")
    slim = {k: tree[k] for k in SLIM_KEYS if k in tree}
    meta["retained_from"] = str(src_p)
    return _write(dst_p, slim, meta)


class CheckpointManager:
    """best / best_ema / periodic retention (HQAViT_CIFAR100.py:1687-1741),
    in the JAX package's layout: ``<dir>/best_model``,
    ``<dir>/best_model_ema``, ``<dir>/checkpoint_epoch_{n}``.

    With ``resume`` the best accuracies so far are read back from the
    directory's ``best_model`` / ``best_model_ema`` meta, so a resumed run
    replaces them only with better ones (JAX's manager starts from 0 and
    overwrites them with the first resumed epoch's; ROADMAP.md, the known
    divergences of the JAX reference)."""

    def __init__(self, directory, model_config: ModelConfig,
                 train_config: TrainingConfig, save_freq: int = 10,
                 resume: bool = False):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.mc = model_config
        self.tc = train_config
        self.save_freq = save_freq
        self.best_acc = self._best("best_model", "val_acc", resume)
        self.best_ema_acc = self._best("best_model_ema", "ema_val_acc",
                                       resume)
        self.bytes_written = 0       # by the last maybe_save

    def _best(self, name: str, key: str, resume: bool) -> float:
        meta = self.dir / name / META_FILE
        if not (resume and meta.exists()):
            return 0.0
        return float(json.loads(meta.read_text())["metrics"].get(key, 0.0))

    def maybe_save(self, state: TrainState, epoch: int, val_acc: float,
                   ema_val_acc: Optional[float] = None) -> Dict[str, bool]:
        saved = {"best": False, "best_ema": False, "periodic": False}
        self.bytes_written = 0

        def save(name, metrics):
            self.bytes_written += save_train_state(
                self.dir / name, state, self.mc, self.tc, metrics)

        if val_acc > self.best_acc:
            self.best_acc = val_acc
            save("best_model", {"epoch": epoch, "val_acc": val_acc})
            saved["best"] = True
        if ema_val_acc is not None and ema_val_acc > self.best_ema_acc:
            self.best_ema_acc = ema_val_acc
            save("best_model_ema", {"epoch": epoch,
                                    "ema_val_acc": ema_val_acc})
            saved["best_ema"] = True
        if self.save_freq and epoch % self.save_freq == 0:
            save(f"checkpoint_epoch_{epoch}", {"epoch": epoch})
            saved["periodic"] = True
        return saved
