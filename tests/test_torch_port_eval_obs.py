"""The port's evaluation and analysis pieces against the JAX package's:
``eval/tta.py`` (the five TTA views), ``eval/metrics.py``
(``validate_tta``, ``confusion_matrix``, ``classification_report``,
``best_worst_classes``), ``obs/analyzer.py`` (``param_breakdown``,
``analytic_flops``, ``memory_breakdown``, ``print_analysis``) and
``cli.evaluate --checkpoint --tta --out-dir``.

The TTA views are held to JAX's preprocessors' outputs within one float32
step of the [0, 1] image through 1/std (``VIEW_ATOL``): XLA's CPU backend
fuses ``x / 255 - mean`` into one FMA, which rounds once where the port
rounds twice (2.4e-7 at most on these images, std 0.25).  The identity and
flip views take no draw; the crop and brightness views get JAX's own
draws (its key folded as ``tta.py:62-69`` folds it) through
``apply_view``, and the port's own draws stay inside JAX's ranges.

A ``slow`` test evaluates the retained ``checkpoints_keep/proc100_hard_ft``
with the port's TTA over the 10k val split on the CPU, against JAX's
recorded 94.74 (``docs/TRAINING_RUNS.md`` §8).
"""

import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qavit_tpu.configs import get_preset as jax_get_preset
from qavit_tpu.data import pipelines as JPL
from qavit_tpu.eval import metrics as JEM
from qavit_tpu.eval.tta import make_tta_preprocessors as jax_tta
from qavit_tpu.nn import build_model as jax_build_model
from qavit_tpu.obs import analyzer as JAN
from qavit_tpu_torch.ckpt.checkpoint import save_train_state
from qavit_tpu_torch.cli import evaluate as cli_evaluate
from qavit_tpu_torch.configs import get_preset
from qavit_tpu_torch.data import pipelines as TPL
from qavit_tpu_torch.data import procgen as TP
from qavit_tpu_torch.eval import metrics as EM
from qavit_tpu_torch.eval import tta as TT
from qavit_tpu_torch.nn.models import HQAViT, build_model
from qavit_tpu_torch.obs import analyzer as AN
from qavit_tpu_torch.train.state import create_train_state
from torch_port_common import one_thread  # noqa: F401 (autouse)

B = 6
PIPE = "proc100_hard_hqa"
VIEW_ATOL = float(np.spacing(np.float32(1.0))) / 0.25


def _images(seed=0, b=B, size=32):
    return np.random.RandomState(seed).randint(
        0, 256, (b, size, size, 3)).astype(np.uint8)


@pytest.fixture(scope="module")
def views():
    """(images, JAX's five views of them as the first batch, JAX's crop
    offsets of views 2 and 3 and brightness factors of view 4)."""
    aug = JPL.get_pipeline(PIPE).aug
    imgs = _images()
    out = [np.asarray(p(jnp.asarray(imgs))) for p in jax_tta(aug, seed=3)]

    def key(view):
        return jax.random.fold_in(jax.random.fold_in(
            jax.random.PRNGKey(3), view), 0)

    def offsets(view):
        ys, xs = [], []
        for r in jax.random.split(key(view), B):
            ry, rx = jax.random.split(r)
            ys.append(int(jax.random.randint(ry, (), 0, 5)))
            xs.append(int(jax.random.randint(rx, (), 0, 5)))
        return {"crop_y": torch.tensor(ys), "crop_x": torch.tensor(xs)}

    draws = {2: offsets(2), 3: offsets(3), 4: {"brightness": torch.from_numpy(
        np.array(jax.random.uniform(key(4), (B, 1, 1, 1), minval=0.9,
                                    maxval=1.1)).reshape(B))}}
    return imgs, out, draws


@pytest.mark.parametrize("view", range(5), ids=TT.VIEWS)
def test_tta_view_matches_jax(views, view):
    imgs, ref, draws = views
    aug = TPL.get_pipeline(PIPE).aug
    got = TT.apply_view(view, torch.from_numpy(imgs), draws.get(view, {}),
                        aug).numpy()
    assert got.shape == ref[view].shape == (B, 32, 32, 3)
    np.testing.assert_allclose(got, ref[view], rtol=0, atol=VIEW_ATOL)
    if view in (2, 3):                       # the padding is zero pixels
        assert np.isclose(got, -2.0).any()


def test_tta_views_structure_and_draws():
    aug = TPL.get_pipeline(PIPE).aug
    x = torch.from_numpy(_images(1))
    ident = TT.apply_view(0, x, {}, aug)
    assert torch.equal(ident, TT.apply_view(1, x.flip(2), {}, aug))
    zero = {"crop_y": torch.full((B,), 2), "crop_x": torch.full((B,), 2)}
    assert torch.equal(TT.apply_view(2, x, zero, aug), ident)
    assert torch.equal(TT.apply_view(3, x.flip(2), zero, aug), ident)
    assert torch.equal(TT.apply_view(
        4, x, {"brightness": torch.ones(B)}, aug), ident)

    gen = torch.Generator().manual_seed(0)
    for view in (2, 3):
        p = TT.draw_view_params(view, 4096, gen)
        for k in ("crop_y", "crop_x"):
            assert set(p[k].tolist()) == {0, 1, 2, 3, 4}
    f = TT.draw_view_params(4, 4096, gen)["brightness"]
    assert 0.9 <= float(f.min()) and float(f.max()) < 1.1
    assert float(f.max()) - float(f.min()) > 0.19

    a, b = TT.make_tta_preprocessors(aug, seed=5), \
        TT.make_tta_preprocessors(aug, seed=5)
    first = [p(x) for p in a]
    assert all(torch.equal(u, p(x)) for u, p in zip(first, b))
    second = [p(x) for p in a]               # the next batch: new draws
    assert torch.equal(first[0], second[0])
    assert not torch.equal(first[2], second[2])
    assert not torch.equal(first[4], second[4])


def test_validate_tta_matches_jax():
    """Five views' logits per batch, the same in both: the same TTA top-1
    and count."""
    rs = np.random.RandomState(4)
    batches = [7, 7, 3]
    logits = [[rs.standard_normal((n, 10)).astype(np.float32)
               for n in batches] for _ in range(5)]
    labels = [rs.randint(0, 10, n) for n in batches]
    loader = [(np.full((n, 1), b), labels[b]) for b, n in enumerate(batches)]
    ref = JEM.validate_tta(
        lambda state, x: jnp.asarray(logits[x[0]][int(x[1][0, 0])]), None,
        [loader] * 5, [lambda im, v=v: (v, im) for v in range(5)])
    tloader = [(torch.from_numpy(x), torch.from_numpy(y)) for x, y in loader]
    got = EM.validate_tta(
        lambda x: torch.from_numpy(logits[x[0]][int(x[1][0, 0])]),
        [tloader] * 5, [lambda im, v=v: (v, im) for v in range(5)])
    assert got == ref and got["count"] == 17


def test_confusion_report_best_worst_match_jax():
    rs = np.random.RandomState(5)
    preds, labels = rs.randint(0, 12, 500), rs.randint(0, 12, 500)
    labels[:40] = 11                          # an uneven class
    names = [f"c{i}" for i in range(12)]
    assert np.array_equal(EM.confusion_matrix(preds, labels, 12),
                          JEM.confusion_matrix(preds, labels, 12))
    report = EM.classification_report(preds, labels, 12)
    assert report == JEM.classification_report(preds, labels, 12)
    assert EM.best_worst_classes(report, 4, names) == \
        JEM.best_worst_classes(report, 4, names)
    assert EM.best_worst_classes(report, 3) == JEM.best_worst_classes(report,
                                                                      3)


@pytest.mark.parametrize("name", ["hqavit_c100", "hqavit_proc_tin"])
def test_analyzer_matches_jax(name, capsys):
    mc, jmc = get_preset(name).model, jax_get_preset(name).model
    for batch in (1, 128):
        assert AN.analytic_flops(mc, batch) == JAN.analytic_flops(jmc, batch)
        assert AN.memory_breakdown(mc, batch) == \
            JAN.memory_breakdown(jmc, None, batch=batch)
    jmodel = jax_build_model(jmc)
    dummy = jnp.zeros((2, jmc.img_size, jmc.img_size, 3))
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        dummy, train=True))["params"]
    with torch.device("meta"):                # shapes only, no values
        model = HQAViT(mc)
    assert AN.param_breakdown(model) == JAN.param_breakdown(shapes)
    assert list(AN.param_breakdown(model).items()) == sorted(
        JAN.param_breakdown(shapes).items(), key=lambda kv: (-kv[1], kv[0]))
    JAN.print_analysis(jmc, shapes)
    ref = capsys.readouterr().out
    AN.print_analysis(mc, model)
    assert capsys.readouterr().out == ref


def test_cli_evaluate_checkpoint_tta_out_dir(tmp_path):
    """``cli.evaluate`` restores a port checkpoint, runs the five views
    and writes the analysis files; the unported Grad-CAM raises."""
    TP.load_or_generate_proc100_hard(str(tmp_path), n_train=8, n_test=12)
    mc = get_preset("hqavit_proc100_hard").model
    state = create_train_state(build_model(mc, "cpu", seed=4), False)
    state.step = 5
    save_train_state(tmp_path / "ck", state, mc, metrics={"val_acc": 1.0})
    r = cli_evaluate.main(["--preset", "hqavit_proc100_hard", "--data-root",
                           str(tmp_path), "--device", "cpu",
                           "--batch-size", "8", "--checkpoint",
                           str(tmp_path / "ck"), "--tta", "--out-dir",
                           str(tmp_path / "ev")])
    assert r["count"] == 12 and math.isfinite(r["loss"])
    assert 0.0 <= r["tta_top1"] <= 100.0
    ev = tmp_path / "ev"
    cm = np.load(ev / "confusion_matrix.npy")
    assert cm.shape == (100, 100) and cm.sum() == 12
    report = json.loads((ev / "classification_report.json").read_text())
    assert len(report) == 100
    bw = json.loads((ev / "best_worst_classes.json").read_text())
    assert len(bw["best"]) == len(bw["worst"]) == 10
    with pytest.raises(NotImplementedError, match="queue 1 item 9"):
        cli_evaluate.main(["--preset", "hqavit_proc100_hard", "--device",
                           "cpu", "--gradcam"])


@pytest.mark.slow
def test_retained_flagship_tta_on_the_val_split():
    """checkpoints_keep/proc100_hard_ft (JAX's TTA top-1 94.74 on its
    eval split, ``docs/TRAINING_RUNS.md`` §8) through the bridge and the
    port's five views on the 10k val split, on the CPU in bf16: within
    0.3 of 94.74."""
    from qavit_tpu.ckpt.checkpoint import _restore_numpy
    from qavit_tpu_torch.ckpt.from_jax import load_jax_params

    path = (Path(__file__).resolve().parents[1] / "checkpoints_keep"
            / "proc100_hard_ft" / "state")
    if not path.exists():
        pytest.skip(f"{path} is not in this checkout")
    tree = _restore_numpy(path.resolve())
    x, y = TP.generate_proc100(10000, seed=7, hard=True)
    preset = get_preset("hqavit_proc100_hard_finetune")
    aug = TPL.get_pipeline(preset.dataset).aug
    model = load_jax_params(HQAViT(preset.model), tree["params"],
                            tree["batch_stats"]).eval()
    loader = [(torch.from_numpy(x[i:i + 500]),
               torch.from_numpy(y[i:i + 500]).long())
              for i in range(0, len(y), 500)]

    @torch.inference_mode()
    def forward(images):
        return model(images)[0]

    r = EM.validate_tta(forward, [loader] * 5,
                        TT.make_tta_preprocessors(aug, seed=0))
    print(f"proc100_hard_ft, port TTA on the 10k val split: "
          f"{r['tta_top1']:.2f} (JAX's record 94.74)")
    assert r["count"] == 10000
    assert abs(r["tta_top1"] - 94.74) <= 0.3
