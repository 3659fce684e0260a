"""``cli.train --device cpu`` with each option of the finetune stage
against the JAX package's pieces, as ``test_slice_matches_jax`` holds the
plain loop (``tests/test_torch_port_train_loop.py``): the narrow 32 px
HQAViT (C=48, two blocks) with mixing, dropout and drop-path off,
``augment_batch`` replaced by ``eval_batch`` on both sides, 2 epochs x 2
steps from the same weights (written by the bridge, read back through
``--init-from``), the JAX side composed as ``qavit_tpu/cli/train.py``
composes it.  Cases: ``--grad-accum 2``, ``--flat-optimizer``,
``--debug-grads`` (JAX's device-resident loop takes no per-leaf
statistics, so its history is the plain one; the port prints the top
layers), and layer-wise LR groups under the finetune's warm-restart
schedule (the group table printed).  ``train_loss``, ``lr``,
``val_loss``, ``val_acc``, ``ema_val_acc`` and ``ema_param_dist`` agree
within 1e-4 relative."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from qavit_tpu.configs.training import TrainingConfig as JaxTC
from qavit_tpu_torch.ckpt.checkpoint import save_train_state
from qavit_tpu_torch.ckpt.from_jax import jax_train_state
from qavit_tpu_torch.cli import train as cli_train
from qavit_tpu_torch.configs import presets as P
from qavit_tpu_torch.configs.training import TrainingConfig
from qavit_tpu_torch.data import augment as TA
from qavit_tpu_torch.data import procgen as TP
from qavit_tpu_torch.nn.models import HQAViT
from test_torch_port_train_loop import B, REL, _jax_loop, _narrow
from torch_port_common import jax_bundle, port_cfg
from torch_port_common import one_thread  # noqa: F401 (autouse)

CASES = {
    "grad_accum": (dict(gradient_accumulation_steps=2), ["--grad-accum",
                                                         "2"]),
    "flat_optimizer": (dict(flat_optimizer=True), ["--flat-optimizer"]),
    "debug_grads": ({}, ["--debug-grads"]),
    "layerwise": (dict(lr_groups="layerwise", schedule="warm_restarts",
                       warm_restart_t0_epochs=1, base_lr=1e-4), []),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_option_matches_jax(case, tmp_path, monkeypatch, capsys):
    fields, flags = CASES[case]
    jcfg = _narrow()
    tcj = JaxTC(batch_size=B, epochs=2, warmup_epochs=1, use_mixup=False,
                use_cutmix=False, use_ema=True, seed=5, eval_batch_size=8,
                **fields)
    tct = TrainingConfig(**dataclasses.asdict(tcj))
    data = tmp_path / "data"
    TP.load_or_generate_proc100_hard(str(data), n_train=12, n_test=16)
    ds = dict(np.load(data / "proc100_hard.npz"))
    _, variables = jax_bundle(jcfg, seed=3, batch=B)
    init = jax_train_state(HQAViT(port_cfg(jcfg)), variables, use_ema=False)
    save_train_state(tmp_path / "init", init, slim=True)
    monkeypatch.setitem(P.PRESETS, "narrow_proc100_hard", lambda: P.Preset(
        port_cfg(jcfg), tct.replace(
            gradient_accumulation_steps=1, flat_optimizer=False),
        "proc100_hard_hqa"))
    monkeypatch.setattr(cli_train, "augment_batch",
                        lambda images, aug, gen: TA.eval_batch(images, aug))
    cli_train.main(["--preset", "narrow_proc100_hard", "--device", "cpu",
                    "--data-root", str(data), "--max-steps-per-epoch", "2",
                    "--init-from", str(tmp_path / "init"),
                    "--checkpoint-dir", str(tmp_path / "ck"),
                    "--log-dir", str(tmp_path / "lg")] + flags)
    out = capsys.readouterr().out
    h = json.loads((tmp_path / "lg" / "training_metrics.json")
                   .read_text())["history"]
    ref = _jax_loop(jcfg, tcj, variables, ds, epochs=2, steps=2)
    assert h["epoch"] == [1, 2]
    for k, want in ref.items():
        np.testing.assert_allclose(h[k], want, rtol=REL, atol=0,
                                   err_msg=k)
    assert ("top grad layers:" in out) == (case == "debug_grads")
    assert ("LR groups (layerwise):" in out) == (case == "layerwise")
    tree = torch.load(tmp_path / "ck" / "best_model_ema" / "state.pt",
                      weights_only=True) if (
        tmp_path / "ck" / "best_model_ema" / "state.pt").exists() else None
    if tree is not None:
        assert ("grad_norm" in tree["opt_state"]) == (
            case == "flat_optimizer")
        k = tct.gradient_accumulation_steps
        assert int(tree["bank_count"]) == 3 * jcfg.depth * k * tree["step"]
