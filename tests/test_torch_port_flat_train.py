"""The flat QAViT in training against the JAX package on the CPU, at a
small size (C=48, 4 heads, depth 2) on both routes' geometries
(torch_port_common.flat_fused64: n=64 in four SWA windows under
``attn_impl="fused_block"``; flat_branch49: the branch path at 49 tokens
in one window), with seed-made weights carried across by ``from_jax``:

* the train forward at dropout and drop-path 0: logits and the bank
  state after three writes a block, against ``model.apply(...,
  train=True)`` (float32, rtol 1e-4 and atol 1e-5, as every float32
  model check);
* the branch path's dropout and drop-path draws at rate 0.1 over one
  forward: each kind's kept share within 4 sigma of 0.9.  They come from
  the port's own generator and counter hash, not from ``jax.random``: a
  divergence by design (ROADMAP.md), so no mask is compared with JAX's;
* the per-tensor pre-clip of qavit_v2_extreme's dwconv leaves (0.1) at
  full width and depth on seed-made gradients large enough to bind,
  against JAX's ``apply_clipping`` and its flat optimizer's norm: one
  norm over the 8 blocks' stacked leaf, as JAX takes it;
* a flat train state saved and restored (the restored model evaluates
  equal to the original, and resumes bit for bit), then ``cli.train``,
  ``--resume`` and ``cli.evaluate --checkpoint --tta`` on
  qavit_v2_extreme_proc100 under ``--attn-impl fused_block``;
* the four flat n=64 presets, ``check_train_geometry`` on flat configs,
  and ``obs/analyzer``'s FLOPs and memory model on flat configs against
  JAX's.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qavit_tpu.configs import get_preset as jax_get_preset
from qavit_tpu.obs import analyzer as JAN
from qavit_tpu.train.flat_optim import make_flat_adamw
from qavit_tpu.train.optim import apply_clipping as jax_apply_clipping
from qavit_tpu_torch.ckpt import checkpoint as C
from qavit_tpu_torch.ckpt.from_jax import (_leaves, _torch_entry, _unstack,
                                           load_jax_params)
from qavit_tpu_torch.configs import get_preset
from qavit_tpu_torch.configs.training import TrainingConfig
from qavit_tpu_torch.data import procgen as TP
from qavit_tpu_torch.kernels import flash_attention as FA
from qavit_tpu_torch.nn import block as BL
from qavit_tpu_torch.nn import layers as L
from qavit_tpu_torch.nn.block import BranchQuadBlock, QuadAttentionBlock
from qavit_tpu_torch.nn.models import QAViT, build_model
from qavit_tpu_torch.obs import analyzer as AN
from qavit_tpu_torch.train.flat_optim import FlatAdamW, flat_adam_init
from qavit_tpu_torch.train.optim import apply_clipping, jax_path, make_schedule
from qavit_tpu_torch.train.state import create_train_state
from qavit_tpu_torch.train.steps import (check_train_geometry, make_eval_step,
                                         make_train_step)
from torch_port_common import (assert_close, flat_branch49, flat_fused64,
                               jax_bundle, port_cfg)
from torch_port_common import one_thread  # noqa: F401 (autouse)

GEOMETRIES = {"fused64": flat_fused64, "branch49": flat_branch49}
FLAT64_PRESETS = ("qavit_v2_c100", "qavit_v2_extreme",
                  "qavit_v2_extreme_proc100", "qavit_v2_extreme_tin")


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_train_forward_matches_jax(geometry):
    jcfg = GEOMETRIES[geometry]().replace(dropout=0.0, drop_path=0.0)
    jmodel, variables = jax_bundle(jcfg, seed=2, batch=2)
    rs = np.random.RandomState(4)
    x = rs.standard_normal((2, jcfg.img_size, jcfg.img_size,
                            3)).astype(np.float32)
    (logits, state) = jax.jit(lambda p, x: jmodel.apply(
        {"params": p}, x, train=True, bank_count=0,
        rngs={"dropout": jax.random.PRNGKey(1)}))(variables["params"], x)
    model = load_jax_params(QAViT(port_cfg(jcfg)), variables["params"])
    want = QuadAttentionBlock if geometry == "fused64" else BranchQuadBlock
    assert all(type(b) is want for b in model.blocks)
    model.train()
    plog, pstate = model(torch.from_numpy(x), train=True, bank_count=0,
                         rng=L.DropoutRng(0, "cpu"))
    assert_close(plog, logits)
    assert_close(pstate.k, state.k)
    assert_close(pstate.v, state.v)
    assert int(pstate.count) == int(state.count) == 3 * jcfg.depth
    # the writes moved the rows (the comparison above is not of the start)
    assert float((pstate.k - model.global_bank.global_k).detach().abs()
                 .max()) > 0


def test_branch_dropout_draws_keep_nine_tenths(monkeypatch):
    """One train forward of the branch path at dropout 0.1 and drop-path
    0.1: the proj, bottleneck and CCF-FFN dropouts (flax ``Dropout``), the
    attention dropouts (counter hash) and the drop-paths each keep
    0.9 of their draws within 4 sigma, kept values scaled by 1 / 0.9; the
    same seed draws the same masks, another seed others."""
    mc = port_cfg(flat_branch49().replace(dropout=0.1, drop_path=0.1))
    model = build_model(mc, "cpu", seed=3).train()
    x = torch.randn(64, mc.img_size, mc.img_size, 3,
                    generator=torch.Generator().manual_seed(5))
    drawn = {"dropout": [], "attention": [], "drop_path": []}
    keep_mask, fa_mask = L.keep_mask, FA.keep_mask
    path_mask = L.DropPath.mask

    def rec(kind, fn):
        def wrapped(*a, **k):
            m = fn(*a, **k)
            if m is not None:
                drawn[kind].append(m)
            return m
        return wrapped

    monkeypatch.setattr(L, "keep_mask", rec("dropout", keep_mask))
    monkeypatch.setattr(BL, "keep_mask", rec("dropout", keep_mask))
    monkeypatch.setattr(FA, "keep_mask", rec("attention", fa_mask))
    monkeypatch.setattr(L.DropPath, "mask", rec("drop_path", path_mask))
    with torch.no_grad():
        a, _ = model(x, train=True, rng=L.DropoutRng(7, "cpu"))
    # pos_drop + (3 proj drops + 2 bottleneck + 1 ffn + 1 cross proj) a
    # block; 4 attentions a block; 2 drop-paths in block 1 (block 0's
    # rate is 0)
    assert [len(drawn[k]) for k in drawn] == [1 + 7 * mc.depth,
                                              4 * mc.depth, 2]
    for kind, masks in drawn.items():
        if kind == "drop_path":
            keep = torch.cat([m.flatten() for m in masks])
            kept = keep > 0
            scale = 1.0 / torch.tensor(0.9, dtype=torch.float32)
            assert torch.equal(keep[kept], scale.expand(int(kept.sum())))
        else:
            kept = torch.cat([m.flatten() for m in masks])
            assert kept.dtype == torch.bool
        n = kept.numel()
        share = kept.float().mean().item()
        assert abs(share - 0.9) <= 4 * math.sqrt(0.09 / n), (kind, share, n)
    salts = [m.flatten()[:256] for m in drawn["attention"]]
    assert all(not torch.equal(salts[i], salts[j])
               for i in range(len(salts)) for j in range(i))
    y = torch.ones(1000, 10)
    d = L.dropout(y, 0.1, L.DropoutRng(1, "cpu"))
    assert set(d.unique().tolist()) <= {0.0, float(torch.tensor(1 / 0.9))}
    with torch.no_grad():
        b, _ = model(x, train=True, rng=L.DropoutRng(7, "cpu"))
        c, _ = model(x, train=True, rng=L.DropoutRng(8, "cpu"))
    assert torch.equal(a, b) and not torch.equal(a, c)


def _extreme_grads():
    """qavit_v2_extreme's JAX tree with seed-made N(0, 1) gradients (its
    dwconv leaves' norms far above the 0.1 clip) and the port's names
    and gradients made from it."""
    preset = jax_get_preset("qavit_v2_extreme")
    jcfg = preset.model
    _, variables = jax_bundle(jcfg, seed=0, batch=1)
    rs = np.random.RandomState(3)
    grads = jax.tree_util.tree_map(
        lambda a: rs.standard_normal(a.shape).astype(np.float32),
        variables["params"])
    with torch.device("meta"):
        model = QAViT(port_cfg(jcfg))
    names = [n for n, _ in model.named_parameters()]
    by_name = {}
    for path, arr in _leaves(grads):
        for p, a in _unstack(path, arr):
            key, a = _torch_entry(model, p, a)
            by_name[key] = torch.from_numpy(np.ascontiguousarray(a))
    tc = TrainingConfig(**dataclasses.asdict(preset.train))
    return preset.train, tc, variables["params"], grads, names, [
        by_name[n] for n in names]


@pytest.mark.parametrize("optimizer", ["per_tensor", "flat"])
def test_dwconv_pre_clip_merges_the_blocks_as_jax(optimizer):
    """The repair of ``jax_path`` for the flat ``blocks.{j}`` axis: JAX
    stacks the flat model's blocks into one ``blocks`` leaf, so its
    per-tensor clip takes one norm over the 8 blocks' dwconv kernels."""
    assert jax_path("blocks.3.ccf_ffn.dwconv.dwconv.weight") == jax_path(
        "blocks.0.ccf_ffn.dwconv.dwconv.weight") == \
        "blocks/ccf_ffn/dwconv/dwconv/weight"
    tcj, tct, params, grads, names, pgrads = _extreme_grads()
    assert tct.subtree_clip_keys == ("dwconv",)
    if optimizer == "per_tensor":
        jg, jnorm = jax_apply_clipping(grads, tcj)
        clipped, norm = apply_clipping(names, pgrads, tct)
        model = QAViT(port_cfg(jax_get_preset("qavit_v2_extreme").model))
        ref = {}
        for path, arr in _leaves(jax.device_get(jg)):
            for p, a in _unstack(path, arr):
                key, a = _torch_entry(model, p, a)
                ref[key] = a
        for n, g in zip(names, clipped):
            np.testing.assert_allclose(g.numpy(), ref[n], rtol=1e-5,
                                       atol=1e-7, err_msg=n)
    else:
        tx = make_flat_adamw(tcj, lambda step: 1e-3)
        jstate = tx.init(params)
        _, jstate = jax.jit(tx.update)(grads, jstate, params)
        jnorm = jstate.grad_norm
        tparams = [torch.zeros(g.shape) for g in pgrads]
        state = flat_adam_init(tparams)
        FlatAdamW(names, tparams, tct).update(tparams, pgrads, state, 1e-3)
        norm = state.grad_norm
    # the norm after the pre-clip: each dwconv leaf (a norm over its 8
    # blocks) contributes 0.1; a clip per block would contribute 0.1 a
    # block
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-5)


def _tiny_flat_state(mc, tc, seed=0):
    return create_train_state(build_model(mc, "cpu", seed=seed),
                              tc.use_ema, tc.ema_decay,
                              flat=tc.flat_optimizer)


def test_flat_checkpoint_restores_and_evaluates_equal(tmp_path):
    """A flat train state (the fused n=64 geometry, EMA on) saved after
    two steps and restored into a fresh state: the restored model's eval
    logits, live and EMA, equal the original's, and the next step matches
    bit for bit; ``load_for_transfer`` carries its weights to a new
    model."""
    mc = port_cfg(flat_fused64())
    tc = TrainingConfig(batch_size=2, epochs=2, warmup_epochs=1,
                        use_ema=True, use_mixup=False, use_cutmix=False)
    step = make_train_step(mc, tc, make_schedule(tc, 4))
    rs = np.random.RandomState(6)
    x = torch.from_numpy(rs.standard_normal((2, 32, 32, 3)).astype(
        np.float32))
    y = torch.tensor([3, 7])
    ref = _tiny_flat_state(mc, tc)
    for _ in range(2):
        step(ref, x, y, 5)
    C.save_train_state(tmp_path / "ck", ref, mc, tc, {"epoch": 1})
    state, meta = C.restore_train_state(tmp_path / "ck",
                                        _tiny_flat_state(mc, tc, seed=9))
    assert state.step == 2 and int(state.bank_count) == 2 * 3 * mc.depth
    for use_ema in (False, True):
        got = make_eval_step(state.model, state, use_ema)(x, y)["logits"]
        want = make_eval_step(ref.model, ref, use_ema)(x, y)["logits"]
        assert torch.equal(got, want)
    assert torch.equal(step(state, x, y, 5)["loss"],
                       step(ref, x, y, 5)["loss"])
    model = C.load_for_transfer(tmp_path / "ck",
                                build_model(mc, "cpu", seed=4))
    saved = C._load(tmp_path / "ck", torch.device("cpu"))[0]["params"]
    for n, p in model.named_parameters():
        assert torch.equal(p, saved[n]), n


def test_cli_trains_resumes_and_evaluates_a_flat_preset(tmp_path, capsys,
                                                        monkeypatch):
    """``cli.train`` on qavit_v2_extreme_proc100 under ``--attn-impl
    fused_block`` (the plain units on the CPU) at full width, depth cut
    to 2, 2 epochs x 2 steps at B=4 on a seed-made proc100 with a
    checkpoint every epoch, then ``--resume`` from epoch 1's for a third
    epoch, then ``cli.evaluate --checkpoint --tta`` on the last one."""
    import json

    from qavit_tpu_torch.cli import evaluate as cli_evaluate
    from qavit_tpu_torch.cli import train as cli_train
    from qavit_tpu_torch.configs import presets as P

    TP.load_or_generate_proc100(str(tmp_path), n_train=16, n_test=12)
    p = P.PRESETS["qavit_v2_extreme_proc100"]()
    cut = P.Preset(p.model.replace(depth=2, stage_blocks=(2,)),
                   p.train.replace(save_freq=1), p.dataset)
    monkeypatch.setitem(P.PRESETS, "qavit_v2_extreme_proc100", lambda: cut)
    ck = tmp_path / "ck"
    args = ["--preset", "qavit_v2_extreme_proc100", "--attn-impl",
            "fused_block", "--device", "cpu", "--batch-size", "4",
            "--max-steps-per-epoch", "2", "--warmup-epochs", "1",
            "--data-root", str(tmp_path), "--checkpoint-dir", str(ck),
            "--log-dir", str(tmp_path / "lg")]
    cli_train.main(args + ["--epochs", "2"])
    out = capsys.readouterr().out
    assert "Architecture Analysis — qavit_v2_extreme_proc100" in out
    h = json.loads((tmp_path / "lg" / "training_metrics.json")
                   .read_text())["history"]
    assert h["epoch"] == [1, 2]
    assert all(np.isfinite(v) for k in h for v in h[k])
    cli_train.main(args + ["--epochs", "3", "--resume",
                           str(ck / "checkpoint_epoch_1")])
    assert "at step 2 (epoch 2)" in capsys.readouterr().out
    h = json.loads((tmp_path / "lg" / "training_metrics.json")
                   .read_text())["history"]
    assert h["epoch"] == [1, 2, 3]
    tree = torch.load(ck / "checkpoint_epoch_3" / "state.pt",
                      weights_only=True)
    assert tree["step"] == 6 and int(tree["bank_count"]) == 6 * 3 * 2
    r = cli_evaluate.main(["--preset", "qavit_v2_extreme_proc100",
                           "--data-root", str(tmp_path), "--device", "cpu",
                           "--batch-size", "6", "--checkpoint",
                           str(ck / "checkpoint_epoch_3"), "--tta"])
    assert r["count"] == 12 and math.isfinite(r["loss"])
    assert 0.0 <= r["tta_top1"] <= 100.0


@pytest.mark.parametrize("name", FLAT64_PRESETS)
def test_flat64_presets_match_jax(name):
    pj, pt = jax_get_preset(name), get_preset(name)
    assert dataclasses.asdict(pt.model) == dataclasses.asdict(pj.model)
    assert dataclasses.asdict(pt.train) == dataclasses.asdict(pj.train)
    assert pt.dataset == pj.dataset


def test_check_train_geometry_on_flat_configs():
    """Under fused_block the n=64 and n=256 presets pass (their kernels
    train in bf16; float32 at n=256 is refused at the launch, naming
    queue 2 item 2d) and the n=196 preset raises naming queue 2 item 2c;
    the branch path checks nothing."""
    from qavit_tpu_torch.kernels import fused_kernels as K
    from qavit_tpu_torch.kernels.fused_ref import make_geom

    fused = dict(attn_impl="fused_block")
    for name in ("qavit_v2_extreme_proc100", "qavit_v2_extreme_tin"):
        check_train_geometry(get_preset(name).model.replace(**fused))
    tin = get_preset("qavit_v2_extreme_tin").model.replace(**fused)
    assert K.kernel_geometry_error(make_geom(tin), True,
                                   torch.bfloat16) is None
    err = K.kernel_geometry_error(make_geom(tin), True, torch.float32)
    assert "float32 at n=256" in err and "queue 2 item 2d" in err, err
    for name in ("qavit_v2_extreme_tin", "qavit_224_v1_proc"):
        check_train_geometry(get_preset(name).model)
    with pytest.raises(NotImplementedError, match="queue 2 item 2c"):
        check_train_geometry(get_preset("qavit_224_v1_proc").model
                             .replace(**fused))


@pytest.mark.parametrize("name", ["qavit_v2_extreme_proc100",
                                  "qavit_224_v1_proc"])
def test_analyzer_matches_jax_on_flat_configs(name, capsys):
    mc, jmc = get_preset(name).model, jax_get_preset(name).model
    for batch in (1, 256):
        assert AN.analytic_flops(mc, batch) == JAN.analytic_flops(jmc, batch)
        assert AN.memory_breakdown(mc, batch) == \
            JAN.memory_breakdown(jmc, None, batch=batch)
    from qavit_tpu.nn import build_model as jax_build_model
    jmodel = jax_build_model(jmc)
    dummy = jnp.zeros((2, jmc.img_size, jmc.img_size, 3))
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        dummy, train=True))["params"]
    with torch.device("meta"):
        model = QAViT(mc)
    assert AN.param_breakdown(model, depth=2) == JAN.param_breakdown(
        shapes, depth=2)
    JAN.print_analysis(jmc, shapes)
    ref = capsys.readouterr().out
    AN.print_analysis(mc, model)
    assert capsys.readouterr().out == ref
