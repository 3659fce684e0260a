"""The port's checkpoints (``ckpt/checkpoint.py``, ``cli/retain.py``,
``ckpt/from_jax.py`` ``jax_train_state``) against the JAX package's
rules (``qavit_tpu/ckpt/checkpoint.py``, ``tests/test_interpret_ckpt_obs.py``).

* resume: 2 steps, ``save_train_state``, ``restore_train_state`` into a
  freshly built state, 2 more steps equal 4 uninterrupted steps bitwise
  on the CPU (parameters, buffers, Adam's moments and count, the EMA,
  the bank count, the step, the losses);
* a with-EMA checkpoint into a no-EMA template and back, a slim
  retained checkpoint (the template's optimizer state, step and EMA
  decay kept), the meta's keys;
* ``load_for_transfer``: "auto" keeps a head whose shapes match and drops
  one that differs, True always drops it, ``use_ema``, the BatchNorm
  merge; the unported pos-embed resize and SimCLR raise;
* the JAX -> port round trip: a narrow JAX model's numpy trees through
  ``jax_train_state``, ``save_train_state`` and ``restore_train_state``
  give the JAX logits within the float32 tolerance
  (``torch_port_common.F32``);
* an orbax directory given to the port raises, naming the way across;
* ``CheckpointManager`` saves what JAX's saves for the same sequence of
  accuracies; a save that fails midway leaves the previous files whole.
"""

import json
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qavit_tpu.ckpt import CheckpointManager as JaxManager
from qavit_tpu.ckpt import save_train_state as jax_save
from qavit_tpu.configs import get_preset as jax_get_preset
from qavit_tpu.train import create_train_state as jax_create_state
from qavit_tpu.train import make_optimizer
from qavit_tpu_torch.ckpt import checkpoint as C
from qavit_tpu_torch.ckpt.from_jax import jax_train_state
from qavit_tpu_torch.cli import retain as cli_retain
from qavit_tpu_torch.configs import get_preset
from qavit_tpu_torch.configs.model import ModelConfig
from qavit_tpu_torch.configs.training import TrainingConfig
from qavit_tpu_torch.nn.models import HQAViT, build_model
from qavit_tpu_torch.train.optim import make_schedule
from qavit_tpu_torch.train.state import create_train_state
from qavit_tpu_torch.train.steps import make_train_step
from torch_port_common import F32, jax_bundle, port_cfg, to_np

B = 4
JAX_STATE_KEYS = ["bank_count", "batch_stats", "ema_batch_stats",
                  "ema_decay", "ema_params", "opt_state", "params", "step"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread, as ``test_torch_port_train_pieces.py`` runs
    its full-size steps: many small ops, which the suite's parallel
    workers slow down many times over when each spreads them over every
    core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cfg(tiny_cfg):
    return port_cfg(tiny_cfg)


def _state(cfg, use_ema=True, seed=0):
    return create_train_state(build_model(cfg, "cpu", seed=seed), use_ema)


def _batches(cfg, n):
    rs = np.random.RandomState(11)
    return [(torch.from_numpy(rs.standard_normal(
        (B, cfg.img_size, cfg.img_size, 3)).astype(np.float32)),
        torch.from_numpy(rs.randint(0, cfg.num_classes, B)).long())
        for _ in range(n)]


def _tensors(state):
    named = dict(state.model.named_parameters())
    out = {f"p {n}": named[n] for n in state.names}
    out.update({f"b {n}": b for n, b in state.model.named_buffers()})
    out.update({f"mu {i}": t for i, t in enumerate(state.opt.mu)})
    out.update({f"nu {i}": t for i, t in enumerate(state.opt.nu)})
    out.update({f"ema {n}": t for n, t in state.ema_params.items()})
    out.update({f"emab {n}": t for n, t in state.ema_buffers.items()})
    out["bank_count"] = state.bank_count
    return out


def test_resume_equals_uninterrupted_bitwise(cfg, tmp_path):
    tc = TrainingConfig(batch_size=B, epochs=2, warmup_epochs=1)
    step = make_train_step(cfg, tc, make_schedule(tc, 2))
    batches = _batches(cfg, 4)
    ref = _state(cfg)
    ref_losses = [step(ref, x, y, 7)["loss"] for x, y in batches]

    state = _state(cfg)
    losses = [step(state, x, y, 7)["loss"] for x, y in batches[:2]]
    C.save_train_state(tmp_path / "ck", state, cfg, tc, {"epoch": 1})
    del state
    state, meta = C.restore_train_state(tmp_path / "ck", _state(cfg, seed=9))
    losses += [step(state, x, y, 7)["loss"] for x, y in batches[2:]]

    assert torch.equal(torch.stack(losses), torch.stack(ref_losses))
    assert (state.step, state.opt.count, state.ema_decay) == (
        ref.step, ref.opt.count, ref.ema_decay) == (4, 4, tc.ema_decay)
    got, want = _tensors(state), _tensors(ref)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert int(state.bank_count) == 4 * 3 * cfg.depth
    assert meta["metrics"] == {"epoch": 1}
    assert meta["state_keys"] == JAX_STATE_KEYS
    assert ModelConfig.from_dict(meta["model_config"]) == cfg
    assert TrainingConfig.from_dict(meta["train_config"]) == tc


def test_model_config_dict_matches_jax():
    for name in ("hqavit_proc100_hard", "hqavit_proc_tin", "qavit_224_v1"):
        mc = get_preset(name).model
        d = json.loads(json.dumps(mc.to_dict()))
        assert d == json.loads(json.dumps(
            jax_get_preset(name).model.to_dict()))
        assert ModelConfig.from_dict(d) == mc


def test_ema_into_no_ema_and_back(cfg, tmp_path):
    src = _state(cfg, seed=1)
    with torch.no_grad():
        for t in src.ema_params.values():
            t.add_(1.0)
    C.save_train_state(tmp_path / "ema", src)
    plain, _ = C.restore_train_state(tmp_path / "ema",
                                     _state(cfg, use_ema=False, seed=2))
    assert plain.ema_params is None
    for n, p in plain.model.named_parameters():
        assert torch.equal(p, dict(src.model.named_parameters())[n])

    C.save_train_state(tmp_path / "no_ema", plain)
    meta = json.loads((tmp_path / "no_ema" / "meta.json").read_text())
    assert meta["state_keys"] == ["bank_count", "batch_stats", "ema_decay",
                                  "opt_state", "params", "step"]
    back, _ = C.restore_train_state(tmp_path / "no_ema", _state(cfg, seed=3))
    named = dict(back.model.named_parameters())
    for n, t in back.ema_params.items():
        assert torch.equal(t, named[n])            # EMA from the weights
    for n, b in back.model.named_buffers():
        assert torch.equal(back.ema_buffers[n], b)


def test_slim_retained_checkpoint(cfg, tmp_path, monkeypatch):
    tc = TrainingConfig(batch_size=B, epochs=2, warmup_epochs=1)
    step = make_train_step(cfg, tc, make_schedule(tc, 2))
    src = _state(cfg)
    for x, y in _batches(cfg, 2):
        step(src, x, y, 3)
    C.save_train_state(tmp_path / "full", src, cfg, tc, {"val_acc": 5.0})
    monkeypatch.chdir(tmp_path)
    dst = cli_retain.main([str(tmp_path / "full"), "slim"])
    tree = torch.load(tmp_path / dst / "state.pt", weights_only=True)
    assert sorted(tree) == sorted(C.SLIM_KEYS)
    meta = json.loads((tmp_path / dst / "meta.json").read_text())
    assert meta["state_keys"] == sorted(C.SLIM_KEYS)
    assert meta["metrics"] == {"val_acc": 5.0}
    assert meta["retained_from"] == str((tmp_path / "full").resolve())
    assert (tmp_path / dst / "state.pt").stat().st_size < 0.6 * (
        tmp_path / "full" / "state.pt").stat().st_size

    tpl = _state(cfg, seed=4)
    tpl.step, tpl.ema_decay = 17, 0.5
    mu0 = [t.clone() for t in tpl.opt.mu]
    got, _ = C.restore_train_state(tmp_path / dst, tpl)
    assert (got.step, got.ema_decay, got.opt.count) == (17, 0.5, 0)
    assert all(torch.equal(a, b) for a, b in zip(got.opt.mu, mu0))
    for n, p in got.model.named_parameters():
        assert torch.equal(p, dict(src.model.named_parameters())[n])
    for n, t in got.ema_params.items():
        assert torch.equal(t, src.ema_params[n])
    assert int(got.bank_count) == int(src.bank_count) == 2 * 3 * cfg.depth


def test_load_for_transfer_head_rule_ema_and_bn(cfg, tmp_path):
    src = _state(cfg, seed=1)
    with torch.no_grad():
        for t in src.ema_params.values():
            t.mul_(2.0)
        for n, b in src.model.named_buffers():
            if b.is_floating_point():
                b.add_(0.25)
                src.ema_buffers[n].add_(0.5)
    C.save_train_state(tmp_path / "src", src)
    named_src = dict(src.model.named_parameters())

    def fresh(c=cfg):
        return build_model(c, "cpu", seed=5)

    m = C.load_for_transfer(tmp_path / "src", fresh())        # auto, same
    for n, p in m.named_parameters():
        assert torch.equal(p, named_src[n]), n
    for n, b in m.named_buffers():
        assert torch.equal(b, dict(src.model.named_buffers())[n])

    m = C.load_for_transfer(tmp_path / "src", fresh(), drop_head=True)
    ref = dict(fresh().named_parameters())
    for n, p in m.named_parameters():
        want = ref[n] if n.startswith("head") else named_src[n]
        assert torch.equal(p, want), n

    other = cfg.replace(num_classes=7)
    m = C.load_for_transfer(tmp_path / "src", fresh(other))   # auto, new
    ref = dict(fresh(other).named_parameters())
    for n, p in m.named_parameters():
        want = ref[n] if n.startswith("head") else named_src[n]
        assert torch.equal(p, want), n

    m = C.load_for_transfer(tmp_path / "src", fresh(), use_ema=True)
    for n, p in m.named_parameters():
        assert torch.equal(p, src.ema_params[n]), n
    for n, b in m.named_buffers():
        assert torch.equal(b, src.ema_buffers[n]), n

    with pytest.raises(NotImplementedError, match="queue 1 item 8"):
        C.load_for_transfer(tmp_path / "src", fresh(), simclr=True)
    m = fresh()
    with torch.no_grad():
        m.pos_embed = torch.nn.Parameter(torch.zeros(1, 7, cfg.embed_dim))
    with pytest.raises(NotImplementedError,
                       match="queue 1 item 7.*resize_pos_embed"):
        C.load_for_transfer(tmp_path / "src", m)


def test_jax_trees_round_trip_to_the_jax_logits(tiny_cfg, tmp_path):
    jcfg = tiny_cfg.replace(attn_impl="fused_block")
    jmodel, variables = jax_bundle(jcfg, seed=4, batch=2)
    rs = np.random.RandomState(2)
    ema = {"ema_params": jax.tree.map(
        lambda a: a + 0.01 * rs.standard_normal(a.shape).astype(np.float32),
        variables["params"]),
        "ema_batch_stats": variables["batch_stats"]}
    tree = {**variables, **ema, "bank_count": np.int32(48)}
    state = jax_train_state(HQAViT(port_cfg(jcfg)), tree)
    C.save_train_state(tmp_path / "bridged", state, slim=True)
    got, _ = C.restore_train_state(
        tmp_path / "bridged", _state(port_cfg(jcfg), seed=6))
    assert int(got.bank_count) == 48 and got.step == 0

    images = rs.standard_normal((2, jcfg.img_size, jcfg.img_size,
                                 3)).astype(np.float32)
    fwd = jax.jit(lambda v, x: jmodel.apply(v, x, train=False,
                                            bank_count=48)[0])
    ref = fwd(variables, jnp.asarray(images))
    with torch.inference_mode():
        logits, _ = got.model(torch.from_numpy(images), bank_count=48)
    np.testing.assert_allclose(to_np(logits), to_np(ref), **F32)
    ref_ema = fwd({"params": ema["ema_params"],
                   "batch_stats": variables["batch_stats"]},
                  jnp.asarray(images))
    with torch.inference_mode():
        ema_logits, _ = torch.func.functional_call(
            got.model, {**got.ema_params, **got.ema_buffers},
            (torch.from_numpy(images),))
    np.testing.assert_allclose(to_np(ema_logits), to_np(ref_ema), **F32)


def test_orbax_checkpoint_raises_with_the_way_across(tiny_cfg, tmp_path,
                                                      cfg):
    _, variables = jax_bundle(tiny_cfg, seed=0, batch=2)
    tx = make_optimizer(jax_get_preset("hqavit_c100").train, 10)
    jstate = jax_create_state(variables["params"], tx,
                              variables["batch_stats"], use_ema=False)
    jax_save(str(tmp_path / "orbax"), jstate)
    assert (tmp_path / "orbax" / "state").is_dir()
    with pytest.raises(ValueError, match="orbax.*from_jax.jax_train_state"):
        C.restore_train_state(tmp_path / "orbax", _state(cfg))
    with pytest.raises(ValueError, match="orbax"):
        C.load_for_transfer(tmp_path / "orbax", build_model(cfg, "cpu"))


def test_checkpoint_manager_saves_what_jax_saves(tiny_cfg, cfg, tmp_path):
    """The same val / EMA accuracies over 4 epochs with save_freq 2: the
    same directories with the same metrics in their meta."""
    accs = [(1.0, 0.5), (3.0, None), (2.0, 0.9), (3.0, 0.9)]
    _, variables = jax_bundle(tiny_cfg, seed=0, batch=2)
    tx = make_optimizer(jax_get_preset("hqavit_c100").train, 10)
    jstate = jax_create_state(variables["params"], tx,
                              variables["batch_stats"], use_ema=True)
    jm = JaxManager(str(tmp_path / "jax"), tiny_cfg,
                    jax_get_preset("hqavit_c100").train, save_freq=2)
    pm = C.CheckpointManager(tmp_path / "port", cfg, TrainingConfig(),
                             save_freq=2)
    state = _state(cfg)
    for epoch, (acc, ema) in enumerate(accs, 1):
        assert pm.maybe_save(state, epoch, acc, ema) == jm.maybe_save(
            jstate, epoch, acc, ema)
    assert (pm.best_acc, pm.best_ema_acc) == (jm.best_acc, jm.best_ema_acc)

    def saved(root):
        return {p.parent.name: json.loads(p.read_text())["metrics"]
                for p in root.glob("*/meta.json")}

    assert saved(tmp_path / "port") == saved(tmp_path / "jax")
    assert saved(tmp_path / "port") == {
        "best_model": {"epoch": 2, "val_acc": 3.0},
        "best_model_ema": {"epoch": 3, "ema_val_acc": 0.9},
        "checkpoint_epoch_2": {"epoch": 2},
        "checkpoint_epoch_4": {"epoch": 4}}
    # resumed, the port keeps the best so far (JAX's starts from 0)
    again = C.CheckpointManager(tmp_path / "port", cfg, TrainingConfig(),
                                save_freq=2, resume=True)
    assert (again.best_acc, again.best_ema_acc) == (3.0, 0.9)
    assert again.maybe_save(state, 5, 2.9, 0.8) == {
        "best": False, "best_ema": False, "periodic": False}


def test_interrupted_save_leaves_the_old_files(cfg, tmp_path):
    state = _state(cfg)
    C.save_train_state(tmp_path / "best_model", state, metrics={"n": 1})
    before = {p.name: p.read_bytes()
              for p in (tmp_path / "best_model").iterdir()}

    def dies(obj, f):
        f.write(b"partial")
        raise KeyboardInterrupt

    with torch.no_grad():
        next(state.model.parameters()).add_(1.0)
    with mock.patch.object(C.torch, "save", dies), \
            pytest.raises(KeyboardInterrupt):
        C.save_train_state(tmp_path / "best_model", state, metrics={"n": 2})
    after = {p.name: p.read_bytes()
             for p in (tmp_path / "best_model").iterdir()}
    assert after == before                 # no temporary file left either
    restored, meta = C.restore_train_state(tmp_path / "best_model",
                                           _state(cfg, seed=3))
    assert meta["metrics"] == {"n": 1}
