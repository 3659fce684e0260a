"""The flat QAViT's train step on the branch path against
``qavit_tpu.train.make_train_step`` (``tests/torch_port_steps.py``) at
the 224 v1 model's block geometry at a small size
(torch_port_common.flat_branch49: 56 px, patch 8, 49 tokens in one SWA
window, bank v1; C=48, 4 heads, depth 2, B=2).  The fused n=64 geometry
is ``test_torch_port_flat_train_steps.py``.  The recipe is
qavit_v2_extreme's with mixing off and the per-tensor pre-clip of the
dwconv leaves (one norm over the blocks' stacked kernels, as JAX's
scanned leaf) at 0.05, a norm that binds at this width
(``torch_port_steps.CASES``), with the per-tensor and with the flat
optimizer, and ``debug_grads``.  After 1 and 3 steps: each step's loss,
``grad_norm`` and per-leaf gradient norms, every parameter (the bank rows
included), Adam's moments, the EMA and ``bank_count`` (three writes a
block a step).  Tolerances: those of ``torch_port_steps`` (rtol 1e-4,
atol 1e-5 x max|value|, the roundoff-leaf allowance written there)."""

import pytest

import torch_port_steps as S
from torch_port_common import flat_branch49
from torch_port_common import one_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module", params=("extreme", "extreme_flat"))
def runs(request):
    return S.run_case(request.param, flat_branch49())


@pytest.mark.parametrize("steps", [1, 3])
def test_flat_train_step_matches_jax(runs, steps):
    S.check_case(runs, steps)


def test_dwconv_pre_clip_binds(runs):
    S.check_pre_clip_binds(runs)
