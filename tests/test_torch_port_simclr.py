"""SimCLR pretraining through the port (``train/simclr.py``,
``cli/pretrain_simclr.py``, ``cli.train --init-from-simclr``) against the
JAX package's ``qavit_tpu/train/simclr.py`` and its CLI's optimizer, on
seed-made weights carried by the weight bridge (the SimCLR tree under
its ``HQAViT_0`` scope): NT-Xent, the features and projections, 1 and 3
train steps at dropout 0 (with the clip open and binding), the schedule
against optax's, the projection head's init law, backbone extraction and
the transfer into a supervised model, the CLIs end to end, and the
``--init-from`` step reset that the port copies from JAX.

Tolerances: NT-Xent 1e-6 relative; features and projections
``torch_port_common.F32`` (rtol 1e-4, atol 1e-5); the steps as
``tests/torch_port_steps.py`` holds the supervised steps (rtol 1e-4 and
1e-5 x the tensor's largest |value|; a parameter whose gradient is zero
in exact arithmetic, found by its first moment, may move by the summed
learning rate either way; a moment's scale at least 1e-2 of the model's
largest), except that a parameter is held by its update: the port's
p - p0 against JAX's, each at most the summed learning rate, to 1e-4 of
it relative and 1e-3 of the summed learning rate absolute, plus one
float32 ulp each of p and of JAX's value (the rounding of the updated
weight), so that an update skipped or made at another learning rate
fails; with one more allowance.  NT-Xent's gradients at seed-made
weights are ~1e-4 of the supervised loss's (the projections of random
images nearly coincide and the loss sits at ln(2B - 1)), so some elements
of ordinary leaves get a gradient within 100x of Adam's eps (1e-8), where
the update g / (|g| + eps) turns a float32 ulp of g into a visible share
of the learning rate.  Such an element (|g| <= NEAR_EPS at some step, g
read from JAX's first moments step by step) may move by the summed
learning rate either way, and so may the running mean of a BatchNorm
whose conv bias is such a roundoff leaf.  The schedule within 1e-6 of the
peak (optax computes it in float32)."""

import json
import math
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from qavit_tpu.configs import get_preset as jax_get_preset
from qavit_tpu.configs.training import TrainingConfig as JaxTC
from qavit_tpu.nn import build_model as jax_build_model
from qavit_tpu.train import create_train_state as jax_create_state
from qavit_tpu.train import simclr as JS
from qavit_tpu_torch.ckpt import checkpoint as C
from qavit_tpu_torch.ckpt.from_jax import jax_state_dict, load_jax_params
from qavit_tpu_torch.cli import pretrain_simclr as cli_simclr
from qavit_tpu_torch.cli import train as cli_train
from qavit_tpu_torch.configs import presets as P
from qavit_tpu_torch.nn.models import HQAViT, build_model
from qavit_tpu_torch.train import simclr as TS
from qavit_tpu_torch.train.optim import NO_WD_KEYS, jax_path
from qavit_tpu_torch.train.state import create_train_state
from torch_port_common import (F32, assert_close, port_cfg, random_tree,
                               to_np)
from torch_port_common import one_thread  # noqa: F401 (autouse)

B = 4                      # images a view
ROUNDOFF = 1e-6
NEAR_EPS = 100 * 1e-8          # 100 x Adam's eps
EPS32 = float(np.finfo(np.float32).eps)
# the steps' schedule: a small peak, so that an element whose update the
# near-eps allowance admits moves the next forwards by little
PEAK, WARM, TOTAL = 1e-5, 2, 10


def narrow_simclr(**kw):
    """simclr_stl10's model (96 px, 16 learned tokens) narrow and shallow:
    C=48, depth 2, stem channels 8 / 12 / 16, dropout and drop path 0."""
    return jax_get_preset("simclr_stl10").model.replace(
        embed_dim=48, depth=2, stage_blocks=(1, 1, 0, 0), linformer_k=8,
        cnn_c2=8, cnn_c3=12, cnn_c4=16, rrcv_channels=8, dtype="float32",
        attn_impl="fused_block", dropout=0.0, drop_path=0.0, **kw)


def simclr_bundle(jcfg, seed, spread=False):
    """(flax SimCLRNet, seed-made variables); ``spread`` zeroes the biases
    after the pooled features (the final LayerNorm's and the head's), so
    the projections of random views lie apart (1 - cos 0.017-0.069
    against 0.0016-0.0061 with them) and NT-Xent's gradients are not
    mostly the cancellation of equal terms."""
    jm = JS.SimCLRNet(jcfg)
    dummy = jnp.zeros((2, jcfg.img_size, jcfg.img_size, 3))
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        dummy, train=True))
    rs = np.random.RandomState(seed)
    params = random_tree(shapes["params"], rs)
    if spread:
        for leaf in (params["HQAViT_0"]["norm"], params["proj_fc1"],
                     params["proj_fc2"]):
            leaf["bias"] = np.zeros_like(leaf["bias"])
    return jm, {"params": params,
                "batch_stats": random_tree(shapes["batch_stats"], rs)}


def _views(jcfg, seed=5):
    rs = np.random.RandomState(seed)
    return [rs.standard_normal((B, jcfg.img_size, jcfg.img_size, 3)).astype(
        np.float32) for _ in range(2)]


def _port(jcfg, variables):
    return load_jax_params(TS.SimCLRNet(port_cfg(jcfg)), variables["params"],
                           variables["batch_stats"])


@pytest.mark.parametrize("n, t", [(8, 0.5), (16, 0.1), (6, 1.0)])
def test_nt_xent_matches_jax(n, t):
    z = np.random.RandomState(n).standard_normal((n, 32)).astype(np.float32)
    ref = float(JS.nt_xent_loss(jnp.asarray(z), t))
    got = float(TS.nt_xent_loss(torch.from_numpy(z), t))
    assert abs(got - ref) <= 1e-6 * abs(ref)
    # identical views: each row's positive is itself up to the mask
    same = np.concatenate([z[: n // 2]] * 2)
    assert abs(float(TS.nt_xent_loss(torch.from_numpy(same), t))
               - float(JS.nt_xent_loss(jnp.asarray(same), t))) <= 1e-5


def test_features_and_projections_match_jax():
    jcfg = narrow_simclr()
    jm, variables = simclr_bundle(jcfg, 3)
    x = np.concatenate(_views(jcfg))
    z_ref, _ = jm.apply(variables, jnp.asarray(x), train=False)
    feats_ref, _ = jax_build_model(jcfg).apply(
        {"params": variables["params"]["HQAViT_0"],
         "batch_stats": variables["batch_stats"]["HQAViT_0"]},
        jnp.asarray(x), train=False, return_features=True)
    model = _port(jcfg, variables).eval()
    assert "head" not in dict(model.backbone.named_children())
    with torch.no_grad():
        z, _ = model(torch.from_numpy(x))
        feats, _ = model.backbone(torch.from_numpy(x), return_features=True)
    assert z.dtype == feats.dtype == torch.float32
    assert tuple(z.shape) == (2 * B, TS.PROJ_DIM)
    assert_close(feats, feats_ref)
    assert_close(z, z_ref)


def _jax_optimizer(peak=PEAK, warm=WARM, total=TOTAL):
    """``qavit_tpu/cli/pretrain_simclr.py:94-100``."""
    sched = optax.warmup_cosine_decay_schedule(
        init_value=peak / 3, peak_value=peak, warmup_steps=warm,
        decay_steps=total, end_value=1e-6)
    return sched, optax.chain(optax.clip_by_global_norm(1.0),
                              optax.adamw(sched, weight_decay=1e-6))


def _close(port, ref, what, extra=0.0, floor=0.0):
    p, r = to_np(port), to_np(ref)
    assert p.shape == r.shape, (what, p.shape, r.shape)
    atol = 1e-5 * max(float(np.abs(r).max()), floor, 1e-30) + extra
    np.testing.assert_allclose(p, r, rtol=1e-4, atol=atol, err_msg=what)


def _after(name):
    """The conv bias a BatchNorm's running mean follows (``stem_bn`` <-
    ``stem_conv.bias``): a bias whose gradient is roundoff (BatchNorm
    removes it) moves by up to the learning rate either way, and the
    batch mean, so the running mean, moves with it."""
    if not name.endswith("_bn.running_mean"):
        return None
    return name.replace("_bn.running_mean", "_conv.bias")


def _near_eps(mus):
    """Per parameter, the elements whose JAX gradient came within
    NEAR_EPS of zero at one of the steps so far (g_k from the first
    moments: mu_k = 0.9 mu_(k-1) + 0.1 g_k)."""
    out = {}
    for n in mus[0]:
        prev, near = torch.zeros_like(mus[0][n]), None
        for mu in mus:
            g = (mu[n] - 0.9 * prev) / 0.1
            hit = g.abs() <= NEAR_EPS
            near = hit if near is None else near | hit
            prev = mu[n]
        out[n] = near.numpy()
    return out


@pytest.fixture(scope="module", params=[0.5, 0.1], ids=["open", "clipped"])
def simclr_runs(request):
    """(config, temperature, JAX states and metrics, port snapshots and
    metrics) after 1 and 3 steps from the same weights and views; the
    global norm is ~0.4 at temperature 0.5 and ~2.1 at 0.1, where the
    clip binds."""
    t = request.param
    jcfg = narrow_simclr()
    jm, variables = simclr_bundle(jcfg, 7, spread=True)
    v1, v2 = _views(jcfg)
    sched, tx = _jax_optimizer()
    jstate = jax_create_state(variables["params"], tx,
                              variables["batch_stats"], use_ema=False)
    jstep = JS.make_simclr_train_step(jm, tx, JaxTC(), t, sched)
    model = _port(jcfg, variables)
    pstate = create_train_state(model, use_ema=False)
    pstep = TS.make_simclr_train_step(TS.simclr_schedule(PEAK, WARM, TOTAL),
                                      t)
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    masks = []
    real = TS.adamw_update

    def spy(params, grads, state, mask, *a, **k):
        masks.append(list(mask))
        return real(params, grads, state, mask, *a, **k)

    out, jm_, pm, mus = {}, [], [], []
    with mock.patch.object(TS, "adamw_update", spy):
        for i in range(3):
            jstate, m = jstep(jstate, v1, v2, jax.random.PRNGKey(0))
            jm_.append(jax.device_get(m))
            mus.append(jax_state_dict(model, jax.device_get(
                jstate.opt_state[1][0].mu), jax.device_get(
                    jstate.batch_stats)))
            pm.append(pstep(pstate, torch.from_numpy(v1),
                            torch.from_numpy(v2), 0))
            if i in (0, 2):
                out[i + 1] = (jax.device_get(jstate), list(jm_), {
                    "sd": {k: v.detach().clone()
                           for k, v in model.state_dict().items()},
                    "mu": [x.clone() for x in pstate.opt.mu],
                    "nu": [x.clone() for x in pstate.opt.nu],
                    "count": pstate.opt.count, "step": pstate.step,
                    "bank_count": int(pstate.bank_count)}, list(pm),
                    _near_eps(mus))
    return jcfg, t, model, pstate.names, masks, init, out


@pytest.mark.parametrize("steps", [1, 3])
def test_simclr_steps_match_jax(simclr_runs, steps):
    jcfg, t, model, names, masks, init, out = simclr_runs
    jstate, jm, snap, pm, near = out[steps]
    norms = [float(m["grad_norm"]) for m in jm]
    assert all((n > 1.0) == (t < 0.5) for n in norms), norms
    for i in range(steps):
        _close(pm[i]["loss"], jm[i]["loss"], f"loss {i}")
        _close(pm[i]["grad_norm"], jm[i]["grad_norm"], f"grad_norm {i}")
        assert abs(pm[i]["lr"] - float(jm[i]["lr"])) <= 1e-6 * PEAK
    bstats = jstate.batch_stats
    adam = jstate.opt_state[1][0]
    assert int(adam.count) == snap["count"] == snap["step"] == steps
    assert snap["bank_count"] == int(jstate.bank_count) == 3 * jcfg.depth \
        * steps
    mu = jax_state_dict(model, adam.mu, bstats)
    top = max(float(mu[n].abs().max()) for n in names)
    roundoff = {n for n in names
                if float(mu[n].abs().max()) <= ROUNDOFF * top}
    assert "HQAViT_0.stage1_blocks.0.token_upmix.upsample_attn.bias" in \
        roundoff
    sched = TS.simclr_schedule(PEAK, WARM, TOTAL)
    lr_sum = sum(sched(i) for i in range(steps))
    ref = jax_state_dict(model, jstate.params, bstats)
    for k, v in snap["sd"].items():
        if k.endswith("num_batches_tracked"):
            continue
        if k in roundoff or k not in names:       # buffers: no moments
            _close(v, ref[k].numpy(), k,
                   lr_sum if k in roundoff or _after(k) in roundoff else 0.0)
            continue
        # the update itself, port p - p0 against JAX's r - p0: 1e-3 of the
        # summed learning rate, plus an ulp of p and of r (each rounded to
        # float32 once it is updated)
        r, p, p0 = ref[k].numpy(), to_np(v), to_np(init[k])
        du, dr = p - p0, r - p0
        bound = (1e-4 * np.abs(dr) + 1e-3 * lr_sum
                 + EPS32 * (np.abs(p) + np.abs(r)) + lr_sum * near[k])
        assert (np.abs(du - dr) <= bound).all(), (k, np.abs(du - dr).max())
    for key, tree in (("mu", adam.mu), ("nu", adam.nu)):
        ref = jax_state_dict(model, tree, bstats)
        floor = 1e-2 * max(float(ref[n].abs().max()) for n in names)
        for n, x in zip(names, snap[key]):
            extra = ROUNDOFF * top if key == "mu" and n in roundoff else 0.0
            _close(x, ref[n].numpy(), f"{key} {n}", extra, floor)
    # AdamW's weight decay on every leaf, as optax.adamw without a mask:
    # the bank's write path too, which the supervised optimizer skips
    assert masks and all(all(m) for m in masks)
    assert any(any(k in jax_path(n) for k in NO_WD_KEYS) for n in names)


@pytest.mark.parametrize("peak, warm, total", [
    (0.005, 95, 285), (0.005, 390, 975), (0.0424, 5, 700), (0.005, 0, 20),
    (0.01, 1, 2)])
def test_schedule_matches_optax(peak, warm, total):
    ref = optax.warmup_cosine_decay_schedule(
        init_value=peak / 3, peak_value=peak, warmup_steps=warm,
        decay_steps=total, end_value=1e-6)
    ours = TS.simclr_schedule(peak, warm, total)
    steps = np.arange(total + 3)
    want = np.asarray(jax.vmap(ref)(jnp.asarray(steps)))
    got = np.array([ours(int(s)) for s in steps])
    assert np.abs(got - want).max() <= 1e-6 * peak


def test_projection_head_init_law():
    """flax's default Dense init, as JAX's head takes it: lecun_normal, a
    normal truncated at two of its standard deviations with variance
    1 / fan_in; zero biases.  The sample's mean and standard deviation
    within 4 sigma of the law's, at the full width (192 -> 192 -> 128)."""
    from flax import linen as fnn

    net = TS.SimCLRNet(port_cfg(narrow_simclr()))
    assert isinstance(net.proj_fc1, TS.ProjDense)
    assert isinstance(net.proj_fc2, TS.ProjDense)
    gen = torch.Generator().manual_seed(3)
    for fan_in, out in ((192, 192), (192, 128)):
        layer = TS.ProjDense(fan_in, out)
        layer.reset_parameters(gen)
        k = layer.kernel.detach().double().numpy().ravel()
        sigma, n = math.sqrt(1.0 / fan_in), k.size
        assert abs(k.mean()) <= 4 * sigma / math.sqrt(n)
        assert abs(k.std() - sigma) <= 4 * sigma / math.sqrt(2 * n)
        assert np.abs(k).max() <= 2 * sigma / TS.LECUN_TRUNC
        assert torch.equal(layer.bias, torch.zeros_like(layer.bias))
        # JAX's own draw obeys the same law
        kj = np.asarray(fnn.Dense(out).init(jax.random.PRNGKey(fan_in + out),
                                            jnp.zeros((1, fan_in)))
                        ["params"]["kernel"], np.float64).ravel()
        assert abs(kj.std() - sigma) <= 4 * sigma / math.sqrt(2 * n)


def test_extract_backbone_and_transfer(tmp_path, capsys):
    """A SimCLR checkpoint's backbone into the supervised model: every
    backbone parameter copied, the classifier head and the BatchNorm
    statistics the model's own (JAX's ``--init-from-simclr`` merges no
    batch statistics); the names are JAX's backbone paths."""
    cfg = port_cfg(narrow_simclr())
    net = TS.build_simclr(cfg, "cpu", seed=1)
    with torch.no_grad():
        for b in net.buffers():
            if b.is_floating_point():
                b.add_(0.5)
    state = create_train_state(net, use_ema=False)
    C.save_train_state(tmp_path / "sc", state, cfg)
    sup = dict(build_model(cfg, "cpu", seed=2).named_parameters())
    names = dict(net.named_parameters())
    back = TS.extract_backbone_params(names)
    assert sorted(back) == sorted(n for n in sup if not n.startswith("head"))
    assert not any(n.startswith("proj_fc") for n in back)
    with pytest.raises(KeyError, match="no backbone scope"):
        TS.extract_backbone_params(sup)

    fresh = build_model(cfg.replace(num_classes=10), "cpu", seed=2)
    own = {n: p.detach().clone() for n, p in fresh.named_parameters()}
    bufs = {n: b.clone() for n, b in fresh.named_buffers()}
    C.load_for_transfer(tmp_path / "sc", fresh, drop_head=True, simclr=True)
    assert "BatchNorm" not in capsys.readouterr().out
    for n, p in fresh.named_parameters():
        want = own[n] if n.startswith("head") else back[n]
        assert torch.equal(p, want), n
    for n, b in fresh.named_buffers():
        assert torch.equal(b, bufs[n]), n
    # a supervised checkpoint has no backbone scope, as in JAX
    C.save_train_state(tmp_path / "sup", create_train_state(fresh, False))
    with pytest.raises(KeyError, match="no backbone scope"):
        C.load_for_transfer(tmp_path / "sup", fresh, simclr=True)


def test_simclr_transfer_matches_jax(tmp_path, monkeypatch, capsys):
    """``cli.train --init-from-simclr``'s load (JAX's ``cli/train.py``
    :236-243: ``drop_head=True, simclr=True``, no batch statistics)
    against JAX's ``load_for_transfer`` on the same SimCLR weights (its
    orbax read replaced by the same numpy tree): every backbone parameter
    the SimCLR one, the bank's included, the head and the BatchNorm
    statistics the supervised model's own, exactly."""
    from qavit_tpu.ckpt import checkpoint as JC

    jcfg = narrow_simclr()
    _, sc = simclr_bundle(jcfg, 21)
    sup_cfg = jcfg.replace(num_classes=10)
    shapes = jax.eval_shape(lambda: jax_build_model(sup_cfg).init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((2, sup_cfg.img_size, sup_cfg.img_size, 3)), train=True))
    rs = np.random.RandomState(22)
    dst = {"params": random_tree(shapes["params"], rs),
           "batch_stats": random_tree(shapes["batch_stats"], rs)}
    monkeypatch.setattr(JC, "_restore_numpy",
                        lambda _: {"params": sc["params"]})
    jp = JC.load_for_transfer(str(tmp_path / "sc"), dst["params"],
                              drop_head=True, simclr=True)

    C.save_train_state(tmp_path / "sc",
                       create_train_state(_port(jcfg, sc), use_ema=False))
    model = load_jax_params(HQAViT(port_cfg(sup_cfg)), dst["params"],
                            dst["batch_stats"])
    C.load_for_transfer(tmp_path / "sc", model, drop_head=True, simclr=True)
    want = jax_state_dict(model, jax.device_get(jp), dst["batch_stats"])
    own = jax_state_dict(model, dst["params"], dst["batch_stats"])
    got = model.state_dict()
    assert set(want) == {k for k in got
                         if not k.endswith("num_batches_tracked")}
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert torch.equal(got["head.kernel"], own["head.kernel"])
    assert not torch.equal(got["global_bank.global_k"],
                           own["global_bank.global_k"])


@pytest.fixture
def narrow_presets():
    """simclr_stl10 and hqavit_tiny_proc_stl cut to the narrow widths."""
    sc, ps = P.PRESETS["simclr_stl10"](), P.PRESETS["hqavit_tiny_proc_stl"]()
    small = dict(embed_dim=48, depth=2, stage_blocks=(1, 1, 0, 0),
                 linformer_k=8, cnn_c2=8, cnn_c3=12, cnn_c4=16,
                 rrcv_channels=8)
    cut = {"simclr_stl10": P.Preset(sc.model.replace(**small), sc.train,
                                    sc.dataset),
           "hqavit_tiny_proc_stl": P.Preset(ps.model.replace(**small),
                                            ps.train.replace(
                                                eval_batch_size=256),
                                            ps.dataset)}
    with mock.patch.dict(P.PRESETS, {k: (lambda p=p: p)
                                     for k, p in cut.items()}):
        yield cut


def test_cli_pretrain_then_init_from_simclr(tmp_path, narrow_presets,
                                           capsys):
    """``cli.pretrain_simclr --device cpu --synthetic`` for one epoch of
    two steps (``simclr_epoch_1``, ``training_metrics.json`` with JAX's
    keys), then ``cli.train --init-from-simclr`` from its checkpoint."""
    ck, lg = tmp_path / "ck", tmp_path / "lg"
    loss = cli_simclr.main(["--device", "cpu", "--synthetic", "--epochs",
                            "1", "--batch-size", "4",
                            "--max-steps-per-epoch", "2", "--pipeline",
                            "proc_stl_unlabeled", "--checkpoint-dir",
                            str(ck), "--log-dir", str(lg)])
    out = capsys.readouterr().out
    assert "peak LR (substrate default): 0.005" in out
    assert "Epoch 1 [0/2] NT-Xent:" in out and "Epoch 1: NT-Xent" in out
    # chance for 2B = 8 rows is ln(7)
    assert abs(loss - math.log(7)) < 0.5
    tree = torch.load(ck / "simclr_epoch_1" / "state.pt",
                      weights_only=True)
    assert tree["step"] == 2 and tree["opt_state"]["count"] == 2
    assert "HQAViT_0.pos_embed" in tree["params"]
    h = json.loads((lg / "training_metrics.json").read_text())["history"]
    assert h["epoch"] == [1] and len(h["lr"]) == len(h["train_loss"]) == 1

    best = cli_train.main([
        "--preset", "hqavit_tiny_proc_stl", "--device", "cpu", "--synthetic",
        "--epochs", "1", "--batch-size", "4", "--max-steps-per-epoch", "2",
        "--init-from-simclr", str(ck / "simclr_epoch_1"),
        "--checkpoint-dir", str(tmp_path / "ft"), "--log-dir",
        str(tmp_path / "ftlg")])
    out = capsys.readouterr().out
    assert f"SimCLR backbone init from {ck / 'simclr_epoch_1'}" in out
    assert 0.0 <= best <= 100.0


def test_init_from_restarts_the_step_not_the_count(tmp_path, narrow_presets):
    """The known defect of the JAX reference, copied
    (``qavit_tpu/cli/pretrain_simclr.py:107``, ROADMAP.md): ``--init-from``
    resets the step, so the logged schedule starts a fresh warmup, but
    the optimizer's count carries on, and the updates take the schedule
    at that count."""
    common = ["--device", "cpu", "--synthetic", "--epochs", "1",
              "--batch-size", "4", "--max-steps-per-epoch", "2",
              "--pipeline", "proc_stl_unlabeled", "--warmup-epochs", "1"]
    cli_simclr.main(common + ["--checkpoint-dir", str(tmp_path / "a"),
                              "--log-dir", str(tmp_path / "la")])
    lrs = []
    real = TS.adamw_update
    with mock.patch.object(TS, "adamw_update",
                           lambda *a, **k: (lrs.append(a[4]),
                                            real(*a, **k))):
        cli_simclr.main(common + [
            "--init-from", str(tmp_path / "a" / "simclr_epoch_1"),
            "--checkpoint-dir", str(tmp_path / "b"), "--log-dir",
            str(tmp_path / "lb")])
    tree = torch.load(tmp_path / "b" / "simclr_epoch_1" / "state.pt",
                      weights_only=True)
    assert tree["step"] == 2 and tree["opt_state"]["count"] == 4
    sched = TS.simclr_schedule(0.005, 1, 2)
    assert lrs == [sched(2), sched(3)]           # not sched(0), sched(1)


def test_seed_draws_the_weights_and_the_views(tmp_path, narrow_presets):
    """``--seed`` (JAX fixes 0, the default): the weights, the order, the
    views and the dropout come from it."""
    seeds = []
    real = cli_simclr.build_simclr

    def spy(mc, device, seed):
        seeds.append(seed)
        return real(mc, device, seed=seed)

    common = ["--device", "cpu", "--synthetic", "--epochs", "1",
              "--batch-size", "4", "--max-steps-per-epoch", "1",
              "--pipeline", "proc_stl_unlabeled"]
    with mock.patch.object(cli_simclr, "build_simclr", spy):
        for name, extra in (("s0", []), ("s3", ["--seed", "3"])):
            cli_simclr.main(common + extra + [
                "--checkpoint-dir", str(tmp_path / name), "--log-dir",
                str(tmp_path / f"l{name}")])
    assert seeds == [0, 3]
    a, b = (torch.load(tmp_path / n / "simclr_epoch_1" / "state.pt",
                       weights_only=True)["params"] for n in ("s0", "s3"))
    assert not torch.equal(a["HQAViT_0.pos_embed"], b["HQAViT_0.pos_embed"])
    assert cli_simclr.view_seed(0, 3) != cli_simclr.view_seed(0)


def test_unlabeled_split_over_two_gib_needs_the_host_loader(tmp_path,
                                                           monkeypatch,
                                                           narrow_presets):
    monkeypatch.setattr(cli_simclr, "RESIDENT_BYTES", 100)
    with pytest.raises(NotImplementedError, match="queue 1 item 3"):
        cli_simclr.main(["--device", "cpu", "--synthetic", "--epochs", "1",
                         "--checkpoint-dir", str(tmp_path / "c"),
                         "--log-dir", str(tmp_path / "l")])
    assert not (tmp_path / "c").exists()


def test_hqavit_feature_path_matches_logits_path():
    """``return_features`` stops before the head: the head applied to the
    features gives the logits."""
    cfg = port_cfg(narrow_simclr())
    model = build_model(cfg, "cpu", seed=4)
    x = torch.from_numpy(np.concatenate(_views(narrow_simclr(), 9)))
    with torch.no_grad():
        logits, _ = model(x)
        feats, _ = model(x, return_features=True)
        again = model.head(feats, torch.float32)
    np.testing.assert_allclose(to_np(again), to_np(logits), **F32)
    assert isinstance(model, HQAViT)
