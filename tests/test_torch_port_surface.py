"""The rest of the JAX package's surface in the port, against the JAX
package where it has a counterpart: the measured harness of
``obs/analyzer.py``, ``cli.verify_gpu``, ``obs/log_parse.py``, the port
-> JAX weight bridge (``ckpt/to_jax.py``) and the reference state-dict
importer (``ckpt/torch_import.py``, ``cli.import_torch``)."""

import contextlib
import io
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from qavit_tpu.ckpt.torch_import import _leaf_to_torch
from qavit_tpu.ckpt.torch_import import \
    import_torch_state_dict as jax_import_torch
from qavit_tpu.obs.log_parse import parse_training_log as jax_parse_log
from qavit_tpu_torch.ckpt import to_jax as TJ
from qavit_tpu_torch.ckpt.checkpoint import restore_train_state
from qavit_tpu_torch.ckpt.from_jax import jax_train_state, load_jax_params
from qavit_tpu_torch.ckpt.torch_import import (import_torch_state_dict,
                                               load_torch_state_dict)
from qavit_tpu_torch.cli import import_torch as cli_import
from qavit_tpu_torch.cli import verify_gpu
from qavit_tpu_torch.configs import presets as P
from qavit_tpu_torch.nn.models import HQAViT, QAViT, build_model
from qavit_tpu_torch.obs import analyzer as AN
from qavit_tpu_torch.obs import log_parse as LP
from qavit_tpu_torch.obs.metrics import TrainingLogger
from qavit_tpu_torch.train.simclr import SimCLRNet
from qavit_tpu_torch.train.state import create_train_state
from torch_port_common import jax_bundle, port_cfg
from torch_port_common import one_thread  # noqa: F401 (autouse)
import test_torch_port_simclr as SC


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


def _assert_trees_equal(a, b):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert sorted(la) == sorted(lb)
    for k in la:
        assert la[k].shape == lb[k].shape, k
        np.testing.assert_array_equal(la[k], lb[k], err_msg="/".join(k))


# --- the measured harness --------------------------------------------------

def test_benchmark_fn_host_clock():
    calls = []
    r = AN.benchmark_fn(lambda x: calls.append(x) or torch.ones(2), 1,
                        warmup=2, iters=5)
    assert len(calls) == 7 and r["latency_ms"] > 0
    assert r["iters_per_sec"] == pytest.approx(1e3 / r["latency_ms"])


def test_batch_size_sweep_goes_on_past_out_of_memory():
    """A batch that runs out of device memory gives a row with its error,
    the sweep goes on (JAX's catch-and-continue); other errors raise."""
    def make_batch(bs):
        if bs == 4:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory at 4")
        return (torch.ones(bs),)

    with mock.patch.object(torch.cuda, "empty_cache", lambda: None):
        rows = AN.batch_size_sweep(make_batch, lambda x: x * 2, [2, 4, 8])
    assert [r["batch_size"] for r in rows] == [2, 4, 8]
    assert "out of memory" in rows[1]["error"] and "error" not in rows[2]
    assert rows[2]["images_per_sec"] == pytest.approx(
        8 * rows[2]["iters_per_sec"])
    with pytest.raises(ValueError):
        AN.batch_size_sweep(lambda bs: (1,), lambda x: int("x"), [1])


def test_device_memory_stats():
    if torch.cuda.is_available():
        stats = AN.device_memory_stats()
        assert stats["bytes_limit"] > stats["peak_bytes_in_use"] >= 0
    else:
        assert AN.device_memory_stats() is None


def test_verify_gpu_on_the_cpu(capsys):
    """``cli.verify_gpu --device cpu`` at a depth-2 cut of hqavit_c100
    (B=4 for the train steps): the four sections and ``VERDICT: PASS``."""
    base = P.PRESETS["hqavit_c100"]()
    cut = P.Preset(base.model.replace(depth=2, stage_blocks=(1, 1, 0, 0)),
                   base.train, base.dataset)
    with mock.patch.dict(P.PRESETS, {"hqavit_c100": lambda: cut}), \
            mock.patch.object(verify_gpu, "TRAIN_BATCH", 4):
        assert verify_gpu.main(["--device", "cpu", "--batch-sizes", "2,3"])
    out = capsys.readouterr().out
    for title in ("1) Device check", "2) Flash-attention kernel check",
                  "3) Batch-size sweep (fwd + grad)",
                  "4) 3-step training test"):
        assert title in out
    assert "'batch_size': 2" in out and "'batch_size': 3" in out
    assert "VERDICT: PASS (device=True flash=True train=True)" in out


# --- log_parse ---------------------------------------------------------------

def test_log_parse_reads_the_port_logger(tmp_path):
    """The epoch summaries ``TrainingLogger`` prints parse back to their
    values (4 decimals, as printed), as JAX's parser reads them; the plot
    is written where matplotlib is installed."""
    logger = TrainingLogger(str(tmp_path), track_ema=True)
    rows = [{"train_loss": 4.61, "train_acc": 1.2, "val_loss": 4.55,
             "val_acc": 2.5, "ema_val_acc": 1.9, "ema_param_dist": 0.0123,
             "lr": 1.5e-4, "grad_norm": 0.731, "epoch_time": 50.2},
            {"train_loss": 3.97, "train_acc": 9.75, "val_loss": 3.8,
             "val_acc": 12.25, "ema_val_acc": 8.5, "ema_param_dist": 0.0456,
             "lr": 3e-4, "grad_norm": 0.612, "epoch_time": 48.9}]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        print("start of the log")
        for i, r in enumerate(rows, start=1):
            logger.print_epoch_summary(i, r, {"Best Val Acc (%)": 12.25})
    log = tmp_path / "train.log"
    log.write_text(buf.getvalue())
    h = LP.parse_training_log(str(log))
    assert h == jax_parse_log(str(log))
    assert h["epoch"] == [1, 2]
    for key in rows[0]:
        np.testing.assert_allclose(h[key], [round(r[key], 4) for r in rows],
                                   rtol=0, atol=1e-12)
    out = LP.plot_history(h, str(tmp_path / "curves.png"), title="run")
    assert out is not None and (tmp_path / "curves.png").exists()
    assert LP.plot_history({"epoch": []}, str(tmp_path / "x.png")) is None


# --- the port -> JAX bridge --------------------------------------------------

@pytest.mark.parametrize("which", ["hybrid", "flat"])
def test_to_jax_round_trip_is_exact(which, tiny_cfg, tiny_plain_cfg):
    """JAX -> port -> JAX gives every leaf back bit for bit, the scan
    stacks restacked."""
    jcfg = tiny_cfg if which == "hybrid" else tiny_plain_cfg
    _, variables = jax_bundle(jcfg, seed=3)
    model = load_jax_params((HQAViT if jcfg.hybrid else QAViT)(
        port_cfg(jcfg)), variables["params"], variables.get("batch_stats"))
    params, stats = TJ.jax_trees(model)
    _assert_trees_equal(params, variables["params"])
    _assert_trees_equal(stats, variables.get("batch_stats", {}))


@pytest.mark.parametrize("which", ["hybrid", "flat"])
def test_jax_forward_on_port_weights(which, tiny_cfg, tiny_plain_cfg):
    """JAX's forward from ``to_jax`` of a port model built from a seed
    equals the port's logits (1e-5 in float32), bank state included."""
    jcfg = tiny_cfg if which == "hybrid" else tiny_plain_cfg
    jmodel, _ = jax_bundle(jcfg)
    model = build_model(port_cfg(jcfg), "cpu", seed=11)
    with torch.no_grad():
        for name, t in model.named_parameters():   # off the constant inits
            t.add_(0.05 * torch.randn(t.shape, generator=torch.Generator(
                ).manual_seed(len(name))))
    params, stats = TJ.jax_trees(model)
    x = np.random.RandomState(4).standard_normal(
        (2, jcfg.img_size, jcfg.img_size, 3)).astype(np.float32)
    variables = {"params": params, **({"batch_stats": stats} if stats
                                      else {})}
    lj, _ = jax.jit(lambda v, x: jmodel.apply(v, x, train=False,
                                               bank_count=0))(variables, x)
    with torch.no_grad():
        lt, _ = model(torch.from_numpy(x))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-5,
                               atol=1e-5)


def test_to_jax_simclr_scope_and_train_state():
    """SimCLRNet's tree under ``HQAViT_0`` round-trips; a train state's
    tree (EMA, bank count) goes back through ``jax_train_state``."""
    jcfg = SC.narrow_simclr()
    _, variables = SC.simclr_bundle(jcfg, seed=2)
    net = load_jax_params(SimCLRNet(port_cfg(jcfg)), variables["params"],
                          variables["batch_stats"])
    params, stats = TJ.jax_trees(net)
    assert "stage1_blocks" in params["HQAViT_0"]
    _assert_trees_equal(params, variables["params"])
    _assert_trees_equal(stats, variables["batch_stats"])

    state = create_train_state(net, use_ema=True)
    with torch.no_grad():
        for n in state.ema_params:
            state.ema_params[n].mul_(0.5)
    state.bank_count = torch.tensor(37, dtype=torch.int32)
    tree = TJ.jax_tree_of_state(state)
    assert int(tree["bank_count"]) == 37
    back = jax_train_state(SimCLRNet(port_cfg(jcfg)), tree)
    for n, t in back.model.state_dict().items():
        assert torch.equal(t, net.state_dict()[n]), n
    for n, t in back.ema_params.items():
        assert torch.equal(t, state.ema_params[n]), n
    assert int(back.bank_count) == 37


# --- the reference state dict ------------------------------------------------

def _reference_state_dict(jcfg, seed=5):
    """A seed-made state dict with the reference's names and layouts: each
    leaf of JAX's tree (its scan stacks unstacked) named by JAX's
    ``_leaf_to_torch``, its values laid out as the reference stores them
    (the inverse of the importer's transform)."""
    _, variables = jax_bundle(jcfg, seed=seed)
    sd = {}
    for tree in (variables["params"], variables.get("batch_stats", {})):
        for path, a in _leaves(tree):
            if "blocks" in path[0]:
                per = [((f"{path[0]}.{j}",) + path[1:], a[j])
                       for j in range(a.shape[0])]
            else:
                per = [(path, a)]
            for p, v in per:
                key, kind = _leaf_to_torch(p)
                if kind == "kernel" and v.ndim == 4:
                    v = v.transpose(3, 2, 0, 1)        # HWIO -> OIHW
                elif kind in ("kernel", "dense_t") and v.ndim == 2:
                    v = v.T                            # [in, out] -> [out, in]
                sd["module." + key] = torch.from_numpy(np.ascontiguousarray(v))
    return variables, sd


@pytest.mark.parametrize("which", ["hybrid", "flat"])
def test_torch_import_matches_jax(which, tiny_cfg, tiny_plain_cfg):
    """The same reference state dict through the port and through JAX's
    ``import_torch_state_dict`` + ``from_jax``: the same weights."""
    jcfg = tiny_cfg if which == "hybrid" else tiny_plain_cfg
    variables, sd = _reference_state_dict(jcfg)
    np_sd = {k: v.numpy() for k, v in sd.items()}
    jp, jb = jax_import_torch(np_sd, variables["params"],
                              variables.get("batch_stats"))
    cls = HQAViT if jcfg.hybrid else QAViT
    want = load_jax_params(cls(port_cfg(jcfg)), jp, jb).state_dict()
    got = load_torch_state_dict(cls(port_cfg(jcfg)), sd).state_dict()
    for k, t in want.items():
        assert torch.equal(got[k], t), k
    pp, pb = import_torch_state_dict(sd, variables["params"],
                                     variables.get("batch_stats"))
    _assert_trees_equal(pp, jax.tree_util.tree_map(np.asarray, jp))
    with pytest.raises(KeyError, match="missing torch key"):
        load_torch_state_dict(cls(port_cfg(jcfg)),
                              {k: v for k, v in sd.items()
                               if "pos_embed" not in k})


def test_cli_import_torch(tmp_path, tiny_cfg):
    """``cli.import_torch`` on a reference .pth ({'model_state_dict': ...})
    writes a port checkpoint with those weights."""
    _, sd = _reference_state_dict(tiny_cfg)
    pth = tmp_path / "best_model.pth"
    torch.save({"model_state_dict": sd, "epoch": 3}, pth)
    base = P.PRESETS["hqavit_c100"]()
    cut = P.Preset(port_cfg(tiny_cfg), base.train, base.dataset)
    with mock.patch.dict(P.PRESETS, {"hqavit_c100": lambda: cut}):
        state = cli_import.main(["--preset", "hqavit_c100",
                                 "--torch-checkpoint", str(pth), "--out",
                                 str(tmp_path / "ck")])
    want = load_torch_state_dict(HQAViT(port_cfg(tiny_cfg)), sd)
    fresh = create_train_state(build_model(port_cfg(tiny_cfg), "cpu",
                                           seed=1), base.train.use_ema)
    restored, _ = restore_train_state(tmp_path / "ck", fresh)
    for k, t in want.state_dict().items():
        assert torch.equal(restored.model.state_dict()[k], t), k
        assert torch.equal(state.model.state_dict()[k], t), k
