"""Whole train steps of the port against the JAX package's
``make_train_step`` with ``make_optimizer``, for the finetune stage's
options (``test_torch_port_finetune.py``, ``test_torch_port_accum.py``)
and the flat QAViT's recipe (``test_torch_port_flat_train_steps.py``):
a model of either family (HQAViT, e.g. ``tiny_cfg``, or the flat QAViT)
on the same seed-made weights (``ckpt/from_jax.py``) and batch, mixing
off, dropout and drop-path 0, 1 and 3 steps.  Compared: each step's
loss, ``grad_norm``, ``correct`` and ``count``; every parameter (the bank
rows included), Adam's two moments (the flat ones split per tensor), the
EMA, ``bank_count`` and the BatchNorm statistics (HQAViT's; the flat
QAViT has none); under ``debug_grads`` each step's per-leaf gradient
norms.

Tolerance (float32): rtol 1e-4 and an atol of 1e-5 x the largest |value|
of the tensor, with the roundoff-leaf allowance of
``tests/test_torch_port_train_step.py``: a parameter whose JAX gradient
is zero in exact arithmetic (max|mu| at most ROUNDOFF x the model's
largest) moves by up to the learning rate (x its LR multiplier) either
way, 1e-3 of that in its EMA; a moment's atol scale is at least 1e-2 of
the model's largest moment, and a roundoff leaf's first moment, roundoff
too, gets an atol of ROUNDOFF x the model's largest |first moment|.  A
per-leaf gradient norm gets an atol of 1e-5 x the largest leaf norm (a
roundoff leaf's norm is roundoff)."""

import dataclasses

import jax
import numpy as np
import torch
from jax.flatten_util import ravel_pytree

from qavit_tpu.configs.training import TrainingConfig as JaxTC
from qavit_tpu.train import create_train_state as jax_create_state
from qavit_tpu.train import make_optimizer, make_schedule as jax_schedule
from qavit_tpu.train.steps import make_train_step as jax_train_step
from qavit_tpu_torch.ckpt.from_jax import (_leaves, _torch_entry, _unstack,
                                           jax_state_dict, load_jax_params)
from qavit_tpu_torch.configs.training import TrainingConfig
from qavit_tpu_torch.nn.models import HQAViT, QAViT
from qavit_tpu_torch.obs.monitor import leaf_names
from qavit_tpu_torch.train import flat_optim as F
from qavit_tpu_torch.train.optim import (jax_path, make_schedule,
                                         tensor_multipliers)
from qavit_tpu_torch.train.state import create_train_state
from qavit_tpu_torch.train.steps import make_train_step
from torch_port_common import jax_bundle, port_cfg, to_np

STEPS_PER_EPOCH = 10
ROUNDOFF = 1e-6


def close(port, ref, what, extra_atol=0.0, floor=0.0):
    p, r = to_np(port), to_np(ref)
    assert p.shape == r.shape, (what, p.shape, r.shape)
    atol = 1e-5 * max(float(np.abs(r).max()), floor, 1e-30) + extra_atol
    np.testing.assert_allclose(p, r, rtol=1e-4, atol=atol, err_msg=what)



CASES = {
    # name: (TrainingConfig fields, batch, debug_grads)
    "layerwise": (dict(lr_groups="layerwise", head_lr_multiplier=5.0), 4,
                  True),
    "differential": (dict(lr_groups="differential",
                          head_lr_multiplier=10.0), 4, False),
    "accum2": (dict(gradient_accumulation_steps=2), 4, False),
    "accum3": (dict(gradient_accumulation_steps=3), 6, False),
    "accum2_remainder": (dict(gradient_accumulation_steps=2), 5, False),
    "flat": (dict(flat_optimizer=True), 4, True),
    "flat_layerwise_accum2": (dict(flat_optimizer=True,
                                   lr_groups="layerwise",
                                   gradient_accumulation_steps=2), 4,
                              False),
    # qavit_v2_extreme's recipe with mixing off: its weight decay, label
    # smoothing and global clip, the per-tensor pre-clip of every dwconv
    # leaf (one norm over the stacked blocks, as JAX's leaf).  At C=48 the
    # dwconv leaves' gradient norms read 0.02-0.1 on the first step, so
    # the recipe's 0.1 would hardly bind; at 0.05 it clips some leaves and
    # not others
    "extreme": (dict(base_lr=6e-4, weight_decay=0.05, label_smoothing=0.1,
                     max_grad_norm=1.0, subtree_clip_norm=0.05,
                     subtree_clip_keys=("dwconv",)), 2, True),
    "extreme_flat": (dict(base_lr=6e-4, weight_decay=0.05,
                          label_smoothing=0.1, max_grad_norm=1.0,
                          subtree_clip_norm=0.05,
                          subtree_clip_keys=("dwconv",),
                          flat_optimizer=True), 2, True),
}

# a leaf whose JAX gradient is zero in exact arithmetic, in each family:
# TokenUpMix's bias before its LN; the cross branch's key bias (a bias
# added to every key shifts all scores of a query alike)
ROUNDOFF_LEAF = {True: "stage1_blocks.0.token_upmix.upsample_attn.bias",
                 False: "blocks.0.cross_attn.k_proj.bias"}


def _jax_tree_to_port(model, tree, bstats):
    return jax_state_dict(model, jax.device_get(tree), bstats)


def _leaf_map(model, params):
    """JAX leaf path -> the port's leaf name (``monitor.leaf_names``)."""
    out = {}
    for path, arr in _leaves(params):
        p, a = next(_unstack(path, arr))
        key, _ = _torch_entry(model, p, a)
        out["/".join(path)] = jax_path(key)
    return out


def run_case(case, cfg):
    """(case, model, configs, {steps: (JAX state, JAX metrics, port
    snapshot, port metrics)}) after 1 and 3 steps from the same start,
    for the JAX ModelConfig ``cfg`` of either family."""
    fields, b, debug = CASES[case]
    jcfg = cfg.replace(dropout=0.0, drop_path=0.0)
    tcj = JaxTC(batch_size=b, epochs=2, warmup_epochs=1, use_mixup=False,
                use_cutmix=False, use_ema=True, **fields)
    tct = TrainingConfig(**dataclasses.asdict(tcj))
    jmodel, variables = jax_bundle(jcfg, seed=3, batch=b)
    rs = np.random.RandomState(5)
    images = rs.standard_normal(
        (b, jcfg.img_size, jcfg.img_size, 3)).astype(np.float32)
    targets = rs.randint(0, jcfg.num_classes, b).astype(np.int32)

    sched = jax_schedule(tcj, STEPS_PER_EPOCH)
    tx = make_optimizer(tcj, STEPS_PER_EPOCH, sched)
    jstate = jax_create_state(variables["params"], tx,
                              variables.get("batch_stats"), use_ema=True,
                              ema_decay=tcj.ema_decay)
    jstep = jax_train_step(jmodel, tx, jcfg, tcj, sched, debug_grads=debug)

    family = HQAViT if jcfg.hybrid else QAViT
    model = load_jax_params(family(port_cfg(jcfg)), variables["params"],
                            variables.get("batch_stats"))
    pstate = create_train_state(model, True, tct.ema_decay,
                                flat=tct.flat_optimizer)
    pstep = make_train_step(port_cfg(jcfg), tct,
                            make_schedule(tct, STEPS_PER_EPOCH),
                            debug_grads=debug)
    out, jm, pm = {}, [], []
    for i in range(3):
        jstate, m = jstep(jstate, images, targets, jax.random.PRNGKey(0))
        jm.append(jax.device_get(m))
        pm.append(pstep(pstate, torch.from_numpy(images),
                        torch.from_numpy(targets).long(), 0))
        if i in (0, 2):
            out[i + 1] = (jax.device_get(jstate), list(jm),
                          _snapshot(pstate), list(pm))
    return case, model, tcj, jcfg, variables, out


def _snapshot(state):
    params = state.params()
    if isinstance(state.opt, F.FlatAdamState):
        mu = state.opt.split(state.opt.mu, params)
        nu = state.opt.split(state.opt.nu, params)
    else:
        mu, nu = state.opt.mu, state.opt.nu
    return {"state_dict": {k: v.detach().clone() for k, v in
                           state.model.state_dict().items()},
            "mu": [t.clone() for t in mu], "nu": [t.clone() for t in nu],
            "ema": {k: v.clone() for k, v in state.ema_params.items()},
            "bank_count": int(state.bank_count), "names": list(state.names),
            "count": state.opt.count}


def check_case(runs, steps):
    """Hold the port's state and metrics after ``steps`` steps to JAX's."""
    case, model, tcj, jcfg, variables, out = runs
    jstate, jm, snap, pm = out[steps]
    bstats = jstate.batch_stats
    for i in range(steps):
        close(pm[i]["loss"], jm[i]["loss"], f"loss step {i}")
        close(pm[i]["grad_norm"], jm[i]["grad_norm"], f"grad_norm {i}")
        assert int(pm[i]["correct"]) == int(jm[i]["correct"])
        assert pm[i]["count"] == int(jm[i]["count"]) == tcj.batch_size
    flat = tcj.flat_optimizer
    if flat:
        adam = jstate.opt_state
        unravel = ravel_pytree(jstate.params)[1]
        jmu, jnu = unravel(adam.mu), unravel(adam.nu)
        for i in range(steps):
            close(pm[i]["param_norm"], jm[i]["param_norm"],
                   f"param_norm {i}")
    else:
        adam = jstate.opt_state[0]
        jmu, jnu = adam.mu, adam.nu
    mults = tensor_multipliers(snap["names"], TrainingConfig(
        **dataclasses.asdict(tcj))) or [1.0] * len(snap["names"])
    mult = dict(zip(snap["names"], mults))
    lr_steps = sum(float(jax_schedule(tcj, STEPS_PER_EPOCH)(i))
                   for i in range(steps))
    mu = _jax_tree_to_port(model, jmu, bstats)
    top = max(float(mu[n].abs().max()) for n in snap["names"])
    roundoff = {n for n in snap["names"]
                if 0 < float(mu[n].abs().max()) <= ROUNDOFF * top}
    assert ROUNDOFF_LEAF[jcfg.hybrid] in roundoff
    ref = _jax_tree_to_port(model, jstate.params, bstats)
    for k, v in snap["state_dict"].items():
        if k.endswith("num_batches_tracked"):
            continue
        extra = lr_steps * mult[k] if k in roundoff else 0.0
        close(v, ref[k].numpy(), k, extra)
    assert int(adam.count) == snap["count"] == steps
    for key, tree in (("mu", jmu), ("nu", jnu)):
        ref = _jax_tree_to_port(model, tree, bstats)
        floor = 1e-2 * max(float(ref[n].abs().max()) for n in snap["names"])
        for name, t in zip(snap["names"], snap[key]):
            extra = ROUNDOFF * top if key == "mu" and name in roundoff else 0
            close(t, ref[name].numpy(), f"{key} {name}", extra, floor)
    ref = _jax_tree_to_port(model, jstate.ema_params, bstats)
    for name, t in snap["ema"].items():
        close(t, ref[name].numpy(), f"ema {name}",
               lr_steps * mult[name] * 1e-3 if name in roundoff else 0.0)
    k = tcj.gradient_accumulation_steps
    assert snap["bank_count"] == int(jstate.bank_count) == (
        3 * jcfg.depth * steps * k)
    if "per_leaf" in jm[0]:
        # grad_stats: after the clip on the per-tensor path, before it on
        # the flat path, as in JAX
        to_port = _leaf_map(model, variables["params"])
        order = leaf_names(snap["names"])
        for i in range(steps):
            want = {to_port[p]: float(v) for p, v in
                    jm[i]["per_leaf"].items()}
            assert sorted(want) == sorted(order)
            want = np.array([want[n] for n in order])
            close(pm[i]["per_leaf"], want, f"per_leaf step {i} ({case})")


def check_pre_clip_binds(runs):
    """The pre-clip is active at these weights: in JAX's first step a
    dwconv leaf is clipped (at the n=64 geometry some are and some are
    not), so the steps hold the port's grouping to JAX's.  The per-tensor
    path logs the norms after both clips (the global one divides every
    leaf alike), the flat path before them."""
    case, model, tcj, jcfg, variables, out = runs
    jm = out[1][1][0]
    dw = np.array([float(v) for p, v in jm["per_leaf"].items()
                   if "dwconv" in p])
    clip = tcj.subtree_clip_norm
    if not tcj.flat_optimizer:
        gn = float(jm["grad_norm"])
        dw = dw / min(1.0, tcj.max_grad_norm / (gn + 1e-6))
        assert abs(dw.max() - clip) <= 1e-4 * clip, dw
    else:
        assert dw.max() > clip, dw
    if jcfg.attn_impl == "fused_block":
        assert dw.min() < clip, dw
