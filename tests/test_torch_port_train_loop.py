"""The port's train loop (``cli/train.py``, ``obs/metrics.py``,
``obs/monitor.py``) against the JAX package's.

* ``TrainingLogger``: the same metrics give the same
  ``training_metrics.json`` as JAX's logger, a resumed run's overlap
  included (``total_time`` aside, a clock);
* ``cli.train`` end to end on the CPU on a tiny ``proc100_hard`` cache at
  full width, then ``--resume`` from its periodic checkpoint;
* the slice as a whole: a narrow 32 px HQAViT (C=48, two blocks) with
  mixing, dropout and drop-path off, ``augment_batch`` replaced by
  ``eval_batch`` on both sides (the frameworks' random streams cannot
  match), the port's CLI for 2 epochs x 2 steps against JAX's pieces
  composed as ``qavit_tpu/cli/train.py:324-455`` composes them
  (``make_train_step``, ``ema_warmup_decay``, ``evaluate``,
  ``ema_distance``), from the same weights (written by the bridge and
  read back through ``--init-from``): ``train_loss``, ``lr``,
  ``val_loss``, ``val_acc``, ``ema_val_acc`` and ``ema_param_dist``
  within 1e-4 relative;
* every flag whose path is not ported raises before the first step,
  naming its ROADMAP.md item.
"""

import dataclasses
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qavit_tpu.configs import get_preset as jax_get_preset
from qavit_tpu.configs.training import TrainingConfig as JaxTC
from qavit_tpu.data import eval_batch as jax_eval_batch
from qavit_tpu.data import loader as JL
from qavit_tpu.data import pipelines as JPL
from qavit_tpu.eval import evaluate as jax_evaluate
from qavit_tpu.obs import GradientMonitor as JaxMonitor
from qavit_tpu.obs import TrainingLogger as JaxLogger
from qavit_tpu.obs import check_for_nan as jax_check_for_nan
from qavit_tpu.train import create_train_state as jax_create_state
from qavit_tpu.train import make_optimizer, make_schedule as jax_schedule
from qavit_tpu.train.state import ema_distance as jax_ema_distance
from qavit_tpu.train.state import ema_warmup_decay as jax_ema_warmup
from qavit_tpu.train.steps import make_eval_step as jax_eval_step
from qavit_tpu.train.steps import make_train_step as jax_train_step
from qavit_tpu_torch.ckpt.checkpoint import save_train_state
from qavit_tpu_torch.ckpt.from_jax import jax_train_state
from qavit_tpu_torch.cli import train as cli_train
from qavit_tpu_torch.configs import presets as P
from qavit_tpu_torch.configs.training import TrainingConfig
from qavit_tpu_torch.data import augment as TA
from qavit_tpu_torch.data import procgen as TP
from qavit_tpu_torch.nn.models import HQAViT
from qavit_tpu_torch.obs.metrics import BASE_KEYS, EMA_KEYS, TrainingLogger
from qavit_tpu_torch.obs.monitor import GradientMonitor, check_for_nan
from torch_port_common import jax_bundle, port_cfg

REL = 1e-4
B = 4


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


def _epoch_metrics(rs, epoch):
    m = {k: float(rs.uniform(0.1, 90.0)) for k in BASE_KEYS + EMA_KEYS
         if k != "epoch"}
    m["extra_key_not_logged"] = 1.0
    return m


def _json(log_dir):
    d = json.loads((Path(log_dir) / "training_metrics.json").read_text())
    d.pop("total_time")
    return d


def test_logger_json_matches_jax(tmp_path):
    """Five epochs, then a resumed logger re-training epochs 4-6: the
    port's file equals JAX's key for key and value for value."""
    rs = np.random.RandomState(0)
    first = [_epoch_metrics(rs, e) for e in range(1, 6)]
    second = [_epoch_metrics(rs, e) for e in range(4, 7)]
    for track_ema in (True, False):
        dirs = {}
        for name, cls in (("jax", JaxLogger), ("port", TrainingLogger)):
            d = tmp_path / f"{name}_{track_ema}"
            log = cls(str(d), track_ema=track_ema)
            for e, m in enumerate(first, 1):
                log.log_epoch(e, m)
                log.save()
            log = cls(str(d), track_ema=track_ema, resume=True)
            for e, m in enumerate(second, 4):
                log.log_epoch(e, m)
            log.save()
            dirs[name] = d
        port, ref = _json(dirs["port"]), _json(dirs["jax"])
        assert port == ref
        assert list(port["history"]) == list(
            BASE_KEYS + (EMA_KEYS if track_ema else ()))
        assert port["history"]["epoch"] == [1, 2, 3, 4, 5, 6]


def test_epoch_summary_prints_jax_block(capsys):
    rs = np.random.RandomState(1)
    m = _epoch_metrics(rs, 3)
    JaxLogger.print_epoch_summary(None, 3, m, {"note": "x"})
    ref = capsys.readouterr().out
    TrainingLogger.print_epoch_summary(None, 3, m, {"note": "x"})
    assert capsys.readouterr().out == ref


def test_plots_without_matplotlib_print_one_line(tmp_path, monkeypatch,
                                                 capsys):
    log = TrainingLogger(str(tmp_path), track_ema=True)
    log.log_epoch(1, _epoch_metrics(np.random.RandomState(2), 1))
    assert log.plot() == tmp_path / "training_curves.png"
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    capsys.readouterr()
    assert (log.plot(), log.plot_dashboard(), log.plot_ema_distance()) == (
        None, None, None)
    assert capsys.readouterr().out.splitlines() == [
        f"matplotlib is not installed: {name} not written" for name in
        ("training_curves.png", "training_dashboard.png",
         "ema_distance.png")]


def test_monitor_matches_jax():
    jm, pm = JaxMonitor(), GradientMonitor()
    for g, p in ((0.3, 10.0), (51.0, 11.0), (49.0, 12.0), (80.0, 13.0)):
        assert pm.log(g, p) == jm.log(g, p)
    assert (pm.explosion_count, pm.grad_norms, pm.param_norms) == (
        jm.explosion_count, jm.grad_norms, jm.param_norms) == (
        2, [0.3, 51.0, 49.0, 80.0], [10.0, 11.0, 12.0, 13.0])
    for v in (1.0, float("nan"), float("inf"), -float("inf")):
        assert check_for_nan(v) == jax_check_for_nan(v)


def _train(argv, tmp_path, data):
    return cli_train.main(["--preset", "hqavit_proc100_hard", "--device",
                           "cpu", "--data-root", str(data),
                           "--checkpoint-dir", str(tmp_path / "ck"),
                           "--log-dir", str(tmp_path / "lg")] + argv)


def test_cli_train_end_to_end_then_resume(tmp_path, capsys, monkeypatch):
    """hqavit_proc100_hard at full width (depth cut to 2), B=4, 2 epochs
    of 2 steps with a checkpoint every epoch, then ``--resume`` from epoch
    1's checkpoint for a third epoch: the history continues, epoch 2 is
    trained again."""
    data = tmp_path / "data"
    TP.load_or_generate_proc100_hard(str(data), n_train=8, n_test=8)
    common = ["--max-steps-per-epoch", "2", "--batch-size", "4"]
    p = P.PRESETS["hqavit_proc100_hard"]()
    cfg = p.model.replace(depth=2, stage_blocks=(1, 1, 0, 0))
    monkeypatch.setitem(P.PRESETS, "hqavit_proc100_hard", lambda: P.Preset(
        cfg, p.train.replace(save_freq=1), p.dataset))

    _train(["--epochs", "2"] + common, tmp_path, data)
    out = capsys.readouterr().out
    h = json.loads((tmp_path / "lg" / "training_metrics.json")
                   .read_text())["history"]
    assert list(h) == list(BASE_KEYS + EMA_KEYS)
    assert h["epoch"] == [1, 2]
    assert all(np.isfinite(v) for k in h for v in h[k])
    ck = tmp_path / "ck"
    for name in ("checkpoint_epoch_1", "checkpoint_epoch_2"):
        meta = json.loads((ck / name / "meta.json").read_text())
        assert sorted(meta) == ["metrics", "model_config", "state_keys",
                                "train_config"]
    assert "Epoch 1 Summary" in out and "[phases] train" in out
    assert "Architecture Analysis — hqavit_proc100_hard" in out

    _train(["--epochs", "3", "--resume", str(ck / "checkpoint_epoch_1")]
           + common, tmp_path, data)
    out = capsys.readouterr().out
    assert "resumed from" in out and "at step 2 (epoch 2)" in out
    h = json.loads((tmp_path / "lg" / "training_metrics.json")
                   .read_text())["history"]
    assert h["epoch"] == [1, 2, 3]
    tree = torch.load(ck / "checkpoint_epoch_3" / "state.pt",
                      weights_only=True)
    assert tree["step"] == 6 and int(tree["bank_count"]) == 6 * 3 * 2


def _narrow():
    return jax_get_preset("hqavit_proc100_hard").model.replace(
        embed_dim=48, depth=2, stage_blocks=(1, 1, 0, 0), linformer_k=8,
        msda_pad_len=32, cnn_c2=8, cnn_c3=12, cnn_c4=16, rrcv_channels=8,
        dtype="float32", attn_impl="fused_block", dropout=0.0,
        drop_path=0.0)


def _jax_loop(jcfg, tcj, variables, ds, epochs, steps):
    """JAX's pieces composed as its cli/train.py:324-455 composes them,
    with eval_batch in place of augment_batch."""
    jmodel = jax_bundle(jcfg, seed=3, batch=B)[0]
    aug = JPL.get_pipeline("proc100_hard_hqa").aug
    prep = lambda im: jax_eval_batch(jnp.asarray(im), aug)   # noqa: E731
    loader = JL.IndexLoader(len(ds["train_labels"]), tcj.batch_size,
                            shuffle=True, seed=tcj.seed)
    spe = min(len(loader), steps)
    sched = jax_schedule(tcj, spe)
    tx = make_optimizer(tcj, spe, sched)
    state = jax_create_state(variables["params"], tx,
                             variables["batch_stats"], use_ema=True,
                             ema_decay=tcj.ema_decay)
    step = jax_train_step(jmodel, tx, jcfg, tcj, sched)
    # make_eval_step(use_ema=True) runs the eval step on the EMA trees;
    # so does this, with one compiled step for both
    ev = jax_eval_step(jmodel, jcfg)
    ema_distance = jax.jit(jax_ema_distance)
    ebs = tcj.eval_batch_size or 2 * tcj.batch_size
    val = [(ds["test_images"][i:i + ebs], ds["test_labels"][i:i + ebs])
           for i in range(0, len(ds["test_labels"]), ebs)]
    rng = jax.random.PRNGKey(tcj.seed + 1)
    hist = {k: [] for k in ("train_loss", "lr", "val_loss", "val_acc",
                            "ema_val_acc", "ema_param_dist")}
    for epoch in range(1, epochs + 1):
        decay = jax_ema_warmup(epoch, tcj.warmup_epochs, tcj.ema_decay_warmup,
                               tcj.ema_decay)
        state = state.replace(ema_decay=jnp.float32(decay))
        losses = []
        for i, idx in enumerate(loader):
            if i >= spe:
                break
            state, m = step(state, prep(ds["train_images"][idx]),
                            ds["train_labels"][idx].astype(np.int32), rng)
            losses.append(float(m["loss"]))
        r = jax_evaluate(ev, state, val, preprocess=prep)
        re = jax_evaluate(ev, state.replace(
            params=state.ema_params, batch_stats=state.ema_batch_stats),
            val, preprocess=prep)
        pd, _ = ema_distance(state.ema_params, state.params)
        for k, v in (("train_loss", sum(losses) / len(losses)),
                     ("lr", float(sched(state.step))),
                     ("val_loss", r["loss"]), ("val_acc", r["top1"]),
                     ("ema_val_acc", re["top1"]),
                     ("ema_param_dist", float(pd))):
            hist[k].append(v)
    return hist


def test_slice_matches_jax(tmp_path, monkeypatch):
    jcfg = _narrow()
    tcj = JaxTC(batch_size=B, epochs=2, warmup_epochs=1, use_mixup=False,
                use_cutmix=False, use_ema=True, seed=5, eval_batch_size=8)
    tct = TrainingConfig(**dataclasses.asdict(tcj))
    data = tmp_path / "data"
    TP.load_or_generate_proc100_hard(str(data), n_train=12, n_test=16)
    ds = dict(np.load(data / "proc100_hard.npz"))
    _, variables = jax_bundle(jcfg, seed=3, batch=B)

    # the same starting weights for the port, through the bridge
    init = jax_train_state(HQAViT(port_cfg(jcfg)), variables, use_ema=False)
    save_train_state(tmp_path / "init", init, slim=True)
    monkeypatch.setitem(P.PRESETS, "narrow_proc100_hard", lambda: P.Preset(
        port_cfg(jcfg), tct, "proc100_hard_hqa"))
    monkeypatch.setattr(cli_train, "augment_batch",
                        lambda images, aug, gen: TA.eval_batch(images, aug))
    cli_train.main(["--preset", "narrow_proc100_hard", "--device", "cpu",
                    "--data-root", str(data), "--max-steps-per-epoch", "2",
                    "--init-from", str(tmp_path / "init"),
                    "--checkpoint-dir", str(tmp_path / "ck"),
                    "--log-dir", str(tmp_path / "lg")])
    h = json.loads((tmp_path / "lg" / "training_metrics.json")
                   .read_text())["history"]
    ref = _jax_loop(jcfg, tcj, variables, ds, epochs=2, steps=2)
    assert h["epoch"] == [1, 2]
    for k, want in ref.items():
        np.testing.assert_allclose(h[k], want, rtol=REL, atol=0,
                                   err_msg=k)
    assert len(set(h["ema_param_dist"])) == 2 and min(h["lr"]) > 0


@pytest.mark.parametrize("flags, item", [
    (["--steps-per-call", "2"], "queue 3 item 2"),
    (["--data-placement", "host"], "queue 1 item 3"),
    (["--loader", "native"], "queue 1 item 3"),
    (["--init-from-simclr", "x"], "queue 1 item 8"),
    (["--grad-accum", "2"], "queue 1 item 4"),
    (["--flat-optimizer"], "queue 1 item 4"),
    (["--debug-grads"], "queue 1 item 4"),
    (["--preset", "hqavit_proc100_hard_finetune"], "queue 1 item 4"),
])
def test_unported_flags_raise_before_any_step(tmp_path, flags, item):
    argv = ["--preset", "hqavit_proc100_hard", "--device", "cpu",
            "--data-root", str(tmp_path / "absent")] + flags
    with pytest.raises(NotImplementedError, match=item):
        cli_train.main(argv)
    assert not (tmp_path / "absent").exists()      # no data was read


def test_large_dataset_and_several_cards_raise(tmp_path, monkeypatch):
    data = tmp_path / "data"
    TP.load_or_generate_proc100_hard(str(data), n_train=8, n_test=8)
    monkeypatch.setattr(cli_train, "RESIDENT_BYTES", 100)
    with pytest.raises(NotImplementedError, match="queue 1 item 3"):
        cli_train.main(["--preset", "hqavit_proc100_hard", "--device",
                        "cpu", "--data-root", str(data)])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    args = cli_train.parse_args(["--preset", "hqavit_proc100_hard"])
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        cli_train.refuse_unported(args, torch.device("cuda"))


def test_train_segments_stops_only_at_a_saved_epoch(tmp_path):
    """The two-segment drill refuses a stop epoch that gets no periodic
    checkpoint, and reads an epoch as logged only from a whole file."""
    from qavit_tpu_torch.cli import train_segments as TS

    argv = ["--preset", "hqavit_proc100_hard", "--checkpoint-dir",
            str(tmp_path / "ck"), "--log-dir", str(tmp_path / "lg")]
    with pytest.raises(SystemExit, match="every 10 epochs"):
        TS.main(["--stop-after", "4", "--"] + argv)
    with pytest.raises(SystemExit, match="--log-dir"):
        TS.main(["--stop-after", "10", "--"] + argv[:4])
    lg = tmp_path / "lg"
    lg.mkdir()
    assert not TS._logged(lg, 2)
    (lg / "training_metrics.json").write_text('{"history": {"epoch": [1')
    assert not TS._logged(lg, 1)
    log = TrainingLogger(str(lg))
    log.log_epoch(1, {})
    log.log_epoch(2, {})
    log.save()
    assert TS._logged(lg, 2) and not TS._logged(lg, 3)


def test_init_matches_jax():
    """The port's seed-made weights follow JAX's initializers: every
    entry of the JAX tree of the narrow 32 px HQAViT has, drawn by the
    port from its own seed, JAX's mean and standard deviation within 5
    standard errors; constant entries are equal."""
    from qavit_tpu.nn import init_model
    from qavit_tpu_torch.ckpt.from_jax import jax_state_dict
    from qavit_tpu_torch.nn.models import build_model

    jcfg = _narrow()
    # the same tree as the fused units', traced without their kernels
    _, variables = init_model(jcfg.replace(attn_impl="auto"),
                              jax.random.PRNGKey(42))
    variables = jax.tree.map(np.asarray, variables)
    model = build_model(port_cfg(jcfg), "cpu", seed=42)
    ref = jax_state_dict(model, variables["params"],
                         variables["batch_stats"])
    got = model.state_dict()
    assert len(ref) > 100
    for k, t in ref.items():
        a, b = t.double().flatten(), got[k].double().flatten()
        sa, sb = float(a.std()) if a.numel() > 1 else 0.0, \
            float(b.std()) if b.numel() > 1 else 0.0
        if sa == 0.0 or sb == 0.0:
            assert torch.equal(a, b), k
            continue
        n, sd = a.numel(), max(sa, sb)
        assert abs(float(a.mean() - b.mean())) <= 5 * sd / n ** 0.5, k
        assert abs(sa - sb) <= 5 * sd / (2 * n) ** 0.5, k
