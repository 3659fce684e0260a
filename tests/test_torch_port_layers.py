"""The port's hybrid side path and token compression layers against the
flax modules of the JAX package, on the same seed-made weights (loaded
through the weight bridge) and inputs, in float32, at the tiny test
width and at the hqavit_c100 width."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qavit_tpu.nn import block as JB
from qavit_tpu.nn import hybrid as JH
from qavit_tpu_torch.ckpt.from_jax import load_jax_params
from qavit_tpu_torch.nn import block as TB
from qavit_tpu_torch.nn import hybrid as TH
from torch_port_common import assert_close, random_tree

# (embed, cnn c2, c3, c4, rrcv channels, image size, token grid)
WIDTHS = {"tiny": (48, 8, 12, 16, 8, 16, 4),
          "flagship_width": (192, 64, 128, 256, 64, 32, 8)}


@pytest.fixture(params=sorted(WIDTHS))
def width(request):
    return WIDTHS[request.param]


def _run_pair(jmod, tmod, args_np, seed, jkw=None, targs=()):
    """Init ``jmod`` by shape, draw weights, apply both, return outputs."""
    jargs = [jnp.asarray(a) for a in args_np]
    jkw = jkw or {}
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *jargs,
                                              **jkw))
    rs = np.random.RandomState(seed)
    variables = {k: random_tree(v, rs) for k, v in shapes.items()}
    out_j = jax.jit(lambda v, *a: jmod.apply(v, *a, **jkw))(variables, *jargs)
    load_jax_params(tmod, variables["params"], variables.get("batch_stats"))
    with torch.no_grad():
        out_t = tmod(*[torch.from_numpy(a) for a in args_np], *targs)
    return out_j, out_t


def _x(shape, seed):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


def test_cnn_stem_v1_with_bn_stats(width):
    c, c2, c3, c4, _, img, _ = width
    jm = JH.CNNStemV1(c2, c3, c4, dtype=jnp.float32)
    tm = TH.CNNStemV1(c2, c3, c4).eval()
    outs_j, outs_t = _run_pair(jm, tm, [_x((2, img, img, 3), 10)], 11,
                               {"train": False}, (torch.float32,))
    for name, oj, ot in zip(("f2", "f3", "f4"), outs_j, outs_t):
        assert_close(ot, oj, err_msg=name)


def test_lmfa(width):
    c, c2, c3, c4, _, _, hw = width
    jm = JH.LMFAdapter(c, hw, dtype=jnp.float32)
    tm = TH.LMFAdapter(c3, c, hw)
    oj, ot = _run_pair(jm, tm, [_x((2, hw, hw, c3), 12)], 13, None,
                       (torch.float32,))
    assert_close(ot, oj)


def test_rrcv(width):
    c, _, _, _, rec, _, hw = width
    jm = JH.RRCV(c, rec, 1, dtype=jnp.float32)
    tm = TH.RRCV(c, rec, 1)
    oj, ot = _run_pair(jm, tm, [_x((2, hw * hw, c), 14)], 15,
                       {"hw": (hw, hw), "train": False},
                       ((hw, hw), torch.float32))
    assert_close(ot, oj)


def test_split_fusion(width):
    c, *_, hw = width
    jm = JH.SplitFusion(c, 0.1, dtype=jnp.float32)
    tm = TH.SplitFusion(c)
    n = hw * hw
    oj, ot = _run_pair(jm, tm, [_x((2, n, c), 16), _x((2, n, c), 17)], 18,
                       None, (torch.float32,))
    assert_close(ot, oj)


def test_token_learner(width):
    c, *_, hw = width
    jm = JB.TokenLearner(16, dtype=jnp.float32)
    tm = TB.TokenLearner(c, 16)
    oj, ot = _run_pair(jm, tm, [_x((2, hw * hw, c), 19)], 20, None,
                       (torch.float32,))
    assert_close(ot, oj)


def test_token_upmix(width):
    c, *_, hw = width
    jm = JB.TokenUpMix(hw * hw, dtype=jnp.float32)
    tm = TB.TokenUpMix(c, 16, hw * hw)
    oj, ot = _run_pair(jm, tm, [_x((2, 16, c), 21)], 22, None,
                       (torch.float32,))
    assert_close(ot, oj)


def test_learned_tokens_snap_to_square(tiny_cfg):
    """M snaps down to a perfect square, at least 4 (nn/block.py:176)."""
    from torch_port_common import port_cfg

    cfg = port_cfg(tiny_cfg)
    assert TB.learned_tokens(cfg) == 16
    assert TB.learned_tokens(cfg.replace(num_learned_tokens=20)) == 16
    assert TB.learned_tokens(cfg.replace(num_learned_tokens=3)) == 4
