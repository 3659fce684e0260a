"""The port's train step against ``qavit_tpu.train.make_train_step`` on
the ``tiny_cfg`` model (n=16) and on the narrow hqavit_tiny_in
(torch_port_common.narrow_tiny_in: 64 px, n=64 in four SWA windows, 40
pooled MSDA rows, depth 4) with the same seed-made weights and batch: mixup
and cutmix off and dropout and drop-path at 0 (the two frameworks' random
streams cannot match), for 1 and for 3 steps.  Compared after the steps:
the loss and ``grad_norm`` of each step, every parameter (the bank rows
included), Adam's two moments, the EMA, the bank write count and the
BatchNorm running statistics.

Tolerance: float32, rtol 1e-4 and an atol of 1e-5 x the largest |value|
of the tensor (the same algorithm in another order of sums).  A
parameter whose JAX gradient is roundoff gets an atol of lr x steps more
(1e-3 of that in its EMA): Adam divides each gradient element by its own
root mean square, so an element whose gradient is zero in exact
arithmetic (TokenUpMix's bias before its LN, the cross branch's key bias,
the token learner's attention biases, a conv bias before BatchNorm in
training) moves by up to the learning rate either way.  Such a leaf is
found by its first moment: max|mu| at most ROUNDOFF x the model's largest
|mu| (those leaves read <= 6e-8 of it on tiny_cfg, every other leaf with a
gradient >= 7e-5).  For the same reason a moment's atol scale is at least
1e-2 of the largest |moment| of the model.

In bf16 (the default dtype users train in), one forward and backward of
hqavit_c100 at full width and depth 2, and of the narrow hqavit_tiny_in
(dropout, drop-path and mixing off) against ``jax.grad`` of the same loss
in bf16 and in float32: the
global l2 distance of the port's bf16 gradients from JAX's bf16
gradients is held to BF16_VS_JAX x JAX's own bf16-vs-float32 distance,
as the bf16 logits are (tests/torch_port_common.py).  This holds the
plain bf16 path, the reference of the bf16 kernels on the card, to JAX.
There is no per-leaf bound: a one-element leaf (CCF-FFN's gamma) whose
JAX bf16-vs-float32 distance is a few thousandths of its size read up to
4.5x of it (ROADMAP queue 3 item 4)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from qavit_tpu.configs.training import TrainingConfig as JaxTC
from qavit_tpu.nn import build_model as jax_build_model
from qavit_tpu.train import create_train_state as jax_create_state
from qavit_tpu.train import make_optimizer, make_schedule as jax_schedule
from qavit_tpu.train.mix import apply_mix as jax_apply_mix
from qavit_tpu.train.mix import mixed_loss as jax_mixed_loss
from qavit_tpu.train.steps import make_train_step as jax_train_step
from qavit_tpu_torch.ckpt.from_jax import jax_state_dict, load_jax_params
from qavit_tpu_torch.configs.training import TrainingConfig
from qavit_tpu_torch.nn.models import HQAViT
from qavit_tpu_torch.train.optim import make_schedule
from qavit_tpu_torch.train.state import create_train_state
from qavit_tpu_torch.train.steps import loss_and_grads, make_train_step
from torch_port_common import (BF16_VS_JAX, flagship_width_depth2,
                               jax_bundle, narrow_tiny_in, port_cfg, to_np)

STEPS_PER_EPOCH = 10
B = 4
ROUNDOFF = 1e-6


def _close(port, ref, what, extra_atol=0.0, floor=0.0):
    p, r = to_np(port), to_np(ref)
    assert p.shape == r.shape, (what, p.shape, r.shape)
    atol = 1e-5 * max(float(np.abs(r).max()), floor, 1e-30) + extra_atol
    np.testing.assert_allclose(p, r, rtol=1e-4, atol=atol, err_msg=what)


@pytest.fixture(scope="module", params=["tiny", "narrow_tin"])
def runs(request, tiny_cfg):
    """(JAX states and metrics, port state and metrics) after 1 and 3
    steps from the same start."""
    jcfg = (tiny_cfg.replace(attn_impl="fused_block")
            if request.param == "tiny" else narrow_tiny_in())
    jcfg = jcfg.replace(dropout=0.0, drop_path=0.0)
    tcj = JaxTC(batch_size=B, epochs=2, warmup_epochs=1, use_mixup=False,
                use_cutmix=False, use_ema=True)
    tct = TrainingConfig(**dataclasses.asdict(tcj))
    jmodel, variables = jax_bundle(jcfg, seed=3, batch=B)
    rs = np.random.RandomState(5)
    images = rs.standard_normal(
        (B, jcfg.img_size, jcfg.img_size, 3)).astype(np.float32)
    targets = rs.randint(0, jcfg.num_classes, B).astype(np.int32)

    sched = jax_schedule(tcj, STEPS_PER_EPOCH)
    tx = make_optimizer(tcj, STEPS_PER_EPOCH, sched)
    jstate = jax_create_state(variables["params"], tx,
                              variables["batch_stats"], use_ema=True,
                              ema_decay=tcj.ema_decay)
    jstep = jax_train_step(jmodel, tx, jcfg, tcj, sched)

    model = load_jax_params(HQAViT(port_cfg(jcfg)), variables["params"],
                            variables["batch_stats"])
    pstate = create_train_state(model, True, tct.ema_decay)
    pstep = make_train_step(port_cfg(jcfg), tct,
                            make_schedule(tct, STEPS_PER_EPOCH))
    out = {}
    jm, pm = [], []
    for i in range(3):
        jstate, m = jstep(jstate, images, targets, jax.random.PRNGKey(0))
        jm.append(jax.device_get(m))
        pm.append(pstep(pstate, torch.from_numpy(images),
                        torch.from_numpy(targets).long(), 0))
        if i in (0, 2):
            out[i + 1] = (jax.device_get(jstate), list(jm), _snapshot(pstate),
                          list(pm))
    return model, tcj, jcfg, out


def _snapshot(state):
    return {"state_dict": {k: v.detach().clone() for k, v in
                           state.model.state_dict().items()},
            "mu": [t.clone() for t in state.opt.mu],
            "nu": [t.clone() for t in state.opt.nu],
            "ema": {k: v.clone() for k, v in state.ema_params.items()},
            "bank_count": int(state.bank_count), "names": list(state.names),
            "count": state.opt.count}


@pytest.mark.parametrize("steps", [1, 3])
def test_train_step_matches_jax(runs, steps):
    model, tcj, jcfg, out = runs
    jstate, jm, snap, pm = out[steps]
    for i in range(steps):
        _close(pm[i]["loss"], jm[i]["loss"], f"loss step {i}")
        _close(pm[i]["grad_norm"], jm[i]["grad_norm"], f"grad_norm {i}")
    lr_steps = sum(float(jax_schedule(tcj, STEPS_PER_EPOCH)(i))
                   for i in range(steps))
    adam = jstate.opt_state[0]
    mu = jax_state_dict(model, adam.mu, jstate.batch_stats)
    top = max(float(mu[n].abs().max()) for n in snap["names"])
    roundoff = {n for n in snap["names"]
                if 0 < float(mu[n].abs().max()) <= ROUNDOFF * top}
    assert "stage1_blocks.0.token_upmix.upsample_attn.bias" in roundoff
    # parameters and BatchNorm running statistics
    ref = jax_state_dict(model, jstate.params, jstate.batch_stats)
    for k, v in snap["state_dict"].items():
        if k.endswith("num_batches_tracked"):
            continue
        _close(v, ref[k].numpy(), k, lr_steps if k in roundoff else 0.0)
    # Adam's moments and the EMA, laid out like the parameters
    assert int(adam.count) == snap["count"] == steps
    for key, tree in (("mu", adam.mu), ("nu", adam.nu)):
        ref = jax_state_dict(model, tree, jstate.batch_stats)
        floor = 1e-2 * max(float(ref[n].abs().max()) for n in snap["names"])
        for name, t in zip(snap["names"], snap[key]):
            _close(t, ref[name].numpy(), f"{key} {name}", floor=floor)
    ref = jax_state_dict(model, jstate.ema_params, jstate.batch_stats)
    for name, t in snap["ema"].items():
        _close(t, ref[name].numpy(), f"ema {name}",
               lr_steps * 1e-3 if name in roundoff else 0.0)
    assert snap["bank_count"] == int(jstate.bank_count) == (
        3 * jcfg.depth * steps)


def _jax_grads(jcfg, variables, images, targets, tc):
    """(loss, gradients) of one train forward of the JAX model."""
    model = jax_build_model(jcfg)
    batch = jax_apply_mix(jax.random.PRNGKey(0), images, targets, tc)

    def loss_fn(params):
        (logits, _), _ = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            batch.images, train=True, bank_count=0,
            rngs={"dropout": jax.random.PRNGKey(1)},
            mutable=["batch_stats"])
        return jax_mixed_loss(logits, batch, jcfg.num_classes,
                              tc.label_smoothing)

    return jax.jit(jax.value_and_grad(loss_fn))(variables["params"])


@pytest.mark.parametrize("which", ["flagship_width_depth2",
                                   "narrow_tiny_in"])
def test_bf16_grads_within_jax_own_bf16_distance(which):
    jcfg = {"flagship_width_depth2": flagship_width_depth2,
            "narrow_tiny_in": narrow_tiny_in}[which]().replace(
                dropout=0.0, drop_path=0.0)
    tcj = JaxTC(batch_size=8, use_mixup=False, use_cutmix=False)
    _, variables = jax_bundle(jcfg, seed=7, batch=8)
    rs = np.random.RandomState(9)
    images = rs.standard_normal(
        (8, jcfg.img_size, jcfg.img_size, 3)).astype(np.float32)
    targets = rs.randint(0, jcfg.num_classes, 8).astype(np.int32)
    jcfg16 = jcfg.replace(dtype="bfloat16")
    model = load_jax_params(HQAViT(port_cfg(jcfg16)), variables["params"],
                            variables["batch_stats"])
    names = [n for n, _ in model.named_parameters()]
    loss, _, _, grads = loss_and_grads(
        model, names, torch.from_numpy(images),
        torch.from_numpy(targets).long(), 0, 0, port_cfg(jcfg16),
        TrainingConfig(**dataclasses.asdict(tcj)))
    port = dict(zip(names, grads))
    jax_loss, jax_grads = {}, {}
    for cfg in (jcfg, jcfg16):
        jl, jg = _jax_grads(cfg, variables, images, targets, tcj)
        jax_loss[cfg.dtype] = float(jl)
        jax_grads[cfg.dtype] = jax_state_dict(model, jax.device_get(jg),
                                              variables["batch_stats"])

    def dist(a, b):
        return float(np.sqrt(sum(
            float(((to_np(a[n]) - to_np(b[n])) ** 2).sum()) for n in names)))

    j16, j32 = jax_grads["bfloat16"], jax_grads["float32"]
    jax_own = dist(j16, j32)
    vs_jax = dist(port, j16)
    loss = float(loss.detach())
    assert np.isfinite(loss) and jax_own > 0
    assert vs_jax <= BF16_VS_JAX * jax_own, (vs_jax, jax_own, loss,
                                             jax_loss)
