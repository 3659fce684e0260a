"""The port's whole HQAViT eval forward against the JAX package's
``attn_impl="fused_block"`` eval forward on shared seed-made weights, and
the port's entry points (eval step, data, CLI, device rules)."""

import jax
import numpy as np
import pytest
import torch

from qavit_tpu_torch.ckpt.from_jax import load_jax_params
from qavit_tpu_torch.kernels import fused_kernels as K
from qavit_tpu_torch.nn.models import HQAViT
from torch_port_common import (assert_close, flagship_width_depth2,
                               jax_bundle, port_cfg)
from torch_port_common import one_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("which", ["tiny", "flagship_width_depth2"])
def test_hqavit_eval_logits_match_jax(which, tiny_cfg):
    jcfg = (tiny_cfg.replace(attn_impl="fused_block") if which == "tiny"
            else flagship_width_depth2())
    jmodel, variables = jax_bundle(jcfg, seed=7)
    x = np.random.RandomState(8).standard_normal(
        (3, jcfg.img_size, jcfg.img_size, 3)).astype(np.float32)
    lj, bj = jax.jit(lambda v, x: jmodel.apply(v, x, train=False,
                                                bank_count=0))(variables, x)
    model = load_jax_params(HQAViT(port_cfg(jcfg)), variables["params"],
                            variables["batch_stats"]).eval()
    before = dict(K.LAUNCHES)
    with torch.no_grad():
        lt, state = model(torch.from_numpy(x))
    assert lt.dtype == torch.float32
    assert_close(lt, lj)
    np.testing.assert_array_equal(state.k.detach().numpy(), np.asarray(bj.k))
    assert K.LAUNCHES == before


def test_preset_matches_jax():
    import dataclasses

    from qavit_tpu.configs import get_preset as jax_get_preset
    from qavit_tpu_torch.configs import get_preset

    pj, pt = jax_get_preset("hqavit_c100"), get_preset("hqavit_c100")
    assert dataclasses.asdict(pt.model) == dataclasses.asdict(pj.model)
    assert pt.dataset == pj.dataset


def test_synthetic_dataset_matches_jax():
    from qavit_tpu.data.datasets import _synthetic
    from qavit_tpu_torch.data.datasets import synthetic_dataset

    dj = _synthetic("cifar100", 32, 100)
    dt = synthetic_dataset("cifar100", 32, 100)
    for a in ("train_images", "train_labels", "test_images", "test_labels"):
        np.testing.assert_array_equal(getattr(dt, a), getattr(dj, a))


def test_eval_batch_matches_jax():
    from qavit_tpu.data import eval_batch as jax_eval_batch
    from qavit_tpu.data import get_pipeline
    from qavit_tpu_torch.data.augment import eval_batch
    from qavit_tpu_torch.data.pipelines import get_pipeline as port_pipeline

    aug = get_pipeline("cifar100_hqa").aug
    imgs = np.random.RandomState(9).randint(0, 256, (2, 32, 32, 3)).astype(
        np.uint8)
    port_aug = port_pipeline("cifar100_hqa").aug
    assert (tuple(port_aug.mean), tuple(port_aug.std)) == (tuple(aug.mean),
                                                           tuple(aug.std))
    np.testing.assert_allclose(
        eval_batch(torch.from_numpy(imgs), port_aug).numpy(),
        np.asarray(jax_eval_batch(imgs, aug)), rtol=1e-6, atol=1e-6)


def test_eval_step_and_aggregation():
    """Summed plain CE, top-1, top-5 and the count, aggregated as the JAX
    package's evaluate does."""
    from qavit_tpu_torch.eval.metrics import evaluate
    from qavit_tpu_torch.train.steps import make_eval_step

    rs = np.random.RandomState(10)
    logits = torch.from_numpy(rs.standard_normal((10, 7)).astype(np.float32))
    targets = torch.from_numpy(rs.randint(0, 7, 10))

    def fake_model(images):
        return logits[images.long()], None

    step = make_eval_step(fake_model)
    idx = torch.arange(10)
    r = evaluate(step, [(idx[:6], targets[:6]), (idx[6:], targets[6:])])
    lf = logits.numpy().astype(np.float64)
    logp = lf - np.log(np.exp(lf).sum(-1, keepdims=True))
    t = targets.numpy()
    top5 = np.argsort(-lf, -1)[:, :5]
    assert r["count"] == 10
    np.testing.assert_allclose(r["loss"], -logp[np.arange(10), t].mean(),
                               rtol=1e-5)
    assert r["top1"] == pytest.approx(100 * (lf.argmax(-1) == t).mean())
    assert r["top5"] == pytest.approx(
        100 * (top5 == t[:, None]).any(-1).mean())


def test_cli_evaluate_on_cpu():
    from qavit_tpu_torch.cli import evaluate

    before = dict(K.LAUNCHES)
    r = evaluate.main(["--preset", "hqavit_c100", "--synthetic",
                       "--batch-size", "4", "--batches", "2",
                       "--device", "cpu"])
    assert r["count"] == 8 and r["device"] == "cpu"
    assert np.isfinite(r["loss"]) and r["img_per_s"] > 0
    assert K.LAUNCHES == before


def test_entry_points_need_cuda_unless_told_cpu(monkeypatch):
    from qavit_tpu_torch.cli import evaluate
    from qavit_tpu_torch.configs import get_preset
    from qavit_tpu_torch.nn.models import build_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        evaluate.main(["--preset", "hqavit_c100", "--synthetic"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(get_preset("hqavit_c100").model)


@pytest.mark.parametrize("unit", ["unit_swa", "unit_msda", "unit_cga",
                                  "unit_cross_tail"])
def test_wrappers_never_fall_back_off_the_cpu(unit):
    """A tensor that is not on the CPU gets the kernel or an error: here,
    on the meta device, an error, and no plain result."""
    from qavit_tpu_torch.configs import get_preset
    from qavit_tpu_torch.kernels.fused_params import QuadBlockParams
    from qavit_tpu_torch.kernels.fused_ref import make_geom
    from qavit_tpu_torch.nn.layers import param_tree

    cfg = get_preset("hqavit_c100").model
    g = make_geom(cfg)
    p = param_tree(QuadBlockParams(cfg, g).to("meta"))
    x = torch.empty(2, g.n, g.c, device="meta")
    bank = torch.empty(1, g.bank_s, g.c, device="meta")
    args = {"unit_swa": (p, x, bank, bank),
            "unit_msda": (p, x, bank, bank),
            "unit_cga": (p, x, bank, bank),
            "unit_cross_tail": (p, x, x, x, x, x, bank, bank)}[unit]
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        getattr(K, unit)(*args, g, torch.float32)


def test_kernel_geometry_covers_the_flagship():
    """n=16 in one window, n=64 in four and n=256 in sixteen windows, in
    eval and training (n=64 training and n=256 in bf16: float32 refused
    with a named reason, queue 2 item 2d); n=196 (the 224 presets under
    fused_block) refused with a named reason, in both modes."""
    from qavit_tpu_torch.configs import get_preset
    from qavit_tpu_torch.kernels.fused_ref import make_geom

    cfg = get_preset("hqavit_c100").model
    assert K.kernel_geometry_error(make_geom(cfg)) is None
    assert K.kernel_geometry_error(make_geom(cfg), train=True) is None
    assert K.kernel_geometry_error(make_geom(cfg), True, torch.float32) is None
    g64 = make_geom(cfg.replace(num_learned_tokens=64))
    assert (g64.n, g64.nw, g64.ws2) == (64, 4, 16)
    assert K.kernel_geometry_error(g64) is None
    assert K.kernel_geometry_error(g64, train=True) is None
    assert K.kernel_geometry_error(g64, True, torch.bfloat16) is None
    err = K.kernel_geometry_error(g64, True, torch.float32)
    assert "float32 at n=64 in training" in err and "item 2d" in err, err
    g196 = make_geom(get_preset("qavit_224_v1_proc").model)
    g256 = make_geom(cfg.replace(img_size=128, num_learned_tokens=256))
    tin = make_geom(get_preset("qavit_v2_extreme_tin").model)
    assert (g196.n, g256.n, g256.nw) == (196, 256, 16)
    assert (tin.n, tin.nw, tin.ws2, tin.msda_keep) == (256, 16, 16, 128)
    for g in (g256, tin):
        for train in (False, True):
            assert K.kernel_geometry_error(g, train=train) is None
            assert K.kernel_geometry_error(g, train, torch.bfloat16) is None
            err = K.kernel_geometry_error(g, train, torch.float32)
            assert "float32 at n=256" in err and "item 2d" in err, err
    for train in (False, True):
        err = K.kernel_geometry_error(g196, train=train)
        assert f"got n={g196.n} in {g196.nw} window(s)" in err, err
        assert "queue 2 item 2c" in err


@pytest.mark.parametrize("unit", ["swa", "msda", "cga", "cross_tail"])
def test_launches_refuse_an_uncovered_geometry(unit):
    """Every launch checks the geometry and dtype before it touches the
    library or a tensor, naming the reason: the 224 presets' n=196 in
    eval, n=256 in 16 windows in float32 in train mode and in eval, and
    hqavit_proc_tin's n=64 in train mode in float32 (the n=64 and n=256
    kernels run in bf16)."""
    from qavit_tpu_torch.configs import get_preset
    from qavit_tpu_torch.kernels import fused_ref as R
    from qavit_tpu_torch.kernels.fused_ref import make_geom

    launch = getattr(K, f"launch_{unit}")
    n_act = 5 if unit == "cross_tail" else 1
    train = K.UnitTrain(R.block_rng(1, 0.1, 0.1), {})
    c100 = get_preset("hqavit_c100").model
    for cfg, mode, reason in (
            (get_preset("qavit_224_v1_proc").model, None, "got n=196 in 4"),
            (c100.replace(img_size=128, num_learned_tokens=256), train,
             "float32 at n=256"),
            (get_preset("qavit_v2_extreme_tin").model, None,
             "float32 at n=256"),
            (get_preset("hqavit_proc_tin").model, train,
             "float32 at n=64 in training")):
        g = make_geom(cfg)
        x = torch.empty(2, g.n, g.c, device="meta")
        bank = torch.empty(1, g.bank_s, g.c, device="meta")
        with pytest.raises(ValueError, match=reason):
            launch(None, {}, *([x] * n_act), bank, bank, g, torch.float32,
                   None, mode, K.Grid(1, 1))


def test_port_imports_nothing_of_jax():
    """Every module of the port, and chip_smoke.py, import with JAX, flax,
    optax, orbax and the JAX package made unimportable (as on the card's
    machine)."""
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    code = (
        "import sys, importlib, pkgutil\n"
        "for m in ('jax', 'flax', 'optax', 'orbax', 'qavit_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import qavit_tpu_torch\n"
        "for i in pkgutil.walk_packages(qavit_tpu_torch.__path__,\n"
        "                               'qavit_tpu_torch.'):\n"
        "    importlib.import_module(i.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'flax', 'optax', 'orbax', 'qavit_tpu')\n"
        "       and sys.modules[m] is not None]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True,
                   timeout=120)


def test_every_kernel_entry_point_is_bound():
    """Every ``extern "C"`` entry of qavit_tpu_torch/csrc/*.cu (forward and
    backward units, their shared-memory sizes, the scratch size, the flash
    kernel, the tensor-core self-test and the struct-size checks) gets its
    ctypes types in fused_kernels.bind, and the binding module imports
    with JAX made unimportable."""
    from qavit_tpu_torch.kernels import flash_attention as FA
    from qavit_tpu_torch.kernels import mma_selftest as MS

    import ctypes
    import re
    import subprocess
    import sys
    from pathlib import Path

    from qavit_tpu_torch.kernels.build import CSRC

    entries = set()
    for src in CSRC.glob("*.cu"):
        entries |= set(re.findall(r'extern "C" int (qv_\w+)\(',
                                  src.read_text()))

    class Fn:
        def __init__(self, name, seen):
            self.name, self.seen = name, seen

        def __call__(self, *i):     # only the struct-size checks are called
            if self.name == "qv_flash_struct_size":
                return ctypes.sizeof(FA.FlashArgs)
            if self.name == "qv_mma_selftest_struct_size":
                return ctypes.sizeof(MS.MmaTestArgs)
            return ctypes.sizeof(K._STRUCTS[i[0]])

    class FakeLib:
        def __init__(self):
            self.seen = set()

        def __getattr__(self, name):
            self.seen.add(name)
            fn = Fn(name, self.seen)
            self.__dict__[name] = fn
            return fn

    lib = FakeLib()
    K.bind(lib)
    assert lib.seen == entries, (entries - lib.seen, lib.seen - entries)
    assert {f"qv_{u}" for u in {**K.LAUNCHES, **FA.LAUNCHES}} <= entries
    root = Path(__file__).resolve().parent.parent
    code = ("import sys\n"
            "for m in ('jax', 'flax', 'optax', 'orbax', 'qavit_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import qavit_tpu_torch.kernels.unit_checks\n"
            "import qavit_tpu_torch.cli.bench\n"
            "import qavit_tpu_torch.train.steps\n")
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True,
                   timeout=120)
