"""Gradient accumulation (``train/steps.py`` ``accumulated_grads``)
against the JAX package's ``make_train_step`` (``steps.py:65-101``) on
the ``tiny_cfg`` model: k=2, k=3 and k=2 with a remainder (B=5: the last
sample dropped, ``count`` still 5), 1 and 3 steps, held as
``tests/torch_port_steps.py`` states (parameters with the bank rows,
both moments, the EMA, ``bank_count``, BatchNorm statistics, ``count``,
``correct``).  JAX's ``scan`` carries only the bank's count, so the bank
rows written by micro-batches 1..k-1 are lost and the rows swapped into
the parameters are the last micro-batch's (ROADMAP.md, the known defects
of the JAX reference); the port copies that, and these cases hold it.
Then, as ``tests/test_train.py:246`` holds for JAX, at bank rates 0 k=2
takes the k=1 step."""

import numpy as np
import pytest
import torch

import torch_port_steps as S
from qavit_tpu_torch.configs.model import BankConfig
from qavit_tpu_torch.configs.training import TrainingConfig
from qavit_tpu_torch.nn.models import build_model
from qavit_tpu_torch.train.optim import make_schedule
from qavit_tpu_torch.train.state import create_train_state
from qavit_tpu_torch.train.steps import make_train_step
from torch_port_common import port_cfg
from torch_port_common import one_thread  # noqa: F401 (autouse)

ROUNDOFF = S.ROUNDOFF


@pytest.fixture(scope="module",
                params=("accum2", "accum3", "accum2_remainder"))
def runs(request, tiny_cfg):
    return S.run_case(request.param, tiny_cfg)


@pytest.mark.parametrize("steps", [1, 3])
def test_accumulation_matches_jax(runs, steps):
    """The bank-row defect of JAX's scan is copied: the rows after a step
    are those of the last micro-batch's forward from the step's rows."""
    S.check_case(runs, steps)


def test_accumulation_equals_one_batch_at_bank_rate_zero(tiny_cfg):
    """As ``tests/test_train.py:246`` holds for JAX: with mixing, dropout
    and drop-path off and the bank's update rates 0, the mean of k=2
    micro-batches' gradients is the whole batch's, so k=2 takes the k=1
    step.  The batch is two equal halves, so that BatchNorm's batch
    statistics of a micro-batch are the whole batch's (the running
    statistics, updated once a micro-forward, are left out)."""
    cfg = port_cfg(tiny_cfg).replace(
        dropout=0.0, drop_path=0.0,
        bank=BankConfig(update_rate_warm=0.0, update_rate=0.0))
    tc = TrainingConfig(batch_size=4, use_ema=False, use_mixup=False,
                        use_cutmix=False)
    rs = np.random.RandomState(2)
    half = rs.standard_normal((2, 16, 16, 3)).astype(np.float32)
    x = torch.from_numpy(np.concatenate([half, half]))
    y = torch.tensor([1, 3, 1, 3])
    out = []
    for k in (1, 2):
        state = create_train_state(build_model(cfg, "cpu", seed=0), False)
        tck = tc.replace(gradient_accumulation_steps=k)
        sched = make_schedule(tck, 10)
        m = make_train_step(cfg, tck, sched)(state, x, y, 0)
        out.append((m, state))
    (m1, s1), (m2, s2) = out
    assert (int(s1.bank_count), int(s2.bank_count)) == (3 * cfg.depth,
                                                        6 * cfg.depth)
    torch.testing.assert_close(m2["loss"], m1["loss"], rtol=1e-5, atol=0)
    top = max(float(t.abs().max()) for t in s1.opt.mu)
    for n, mu, a, b in zip(s1.names, s1.opt.mu, s1.params(), s2.params()):
        # a roundoff leaf (zero gradient in exact arithmetic) moves by up
        # to the learning rate either way in each run
        extra = (2 * sched(0) if float(mu.abs().max()) <= ROUNDOFF * top
                 else 0)
        torch.testing.assert_close(b, a, rtol=2e-4, atol=2e-6 + extra,
                                   msg=n)
