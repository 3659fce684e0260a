"""The finetune stage's train-step options (``train/optim.py`` LR groups,
``train/flat_optim.py``, ``obs/monitor.py`` ``grad_stats``, the flat
state in a checkpoint) against the JAX package's; gradient accumulation
is held in ``test_torch_port_accum.py``.

* LR groups: the multiplier of every parameter of the full-width
  hqavit_c100 against JAX's ``lr_group_multipliers`` on the matching leaf
  of the JAX tree, in both modes; the printed group table against the one
  JAX's ``cli/train.py:244-257`` builds from its leaves, for the four
  presets with LR groups;
* whole train steps against JAX's ``make_train_step`` with
  ``make_optimizer`` (``tests/torch_port_steps.py``, which states what is
  compared and the tolerances), 1 and 3 steps: layerwise groups with
  ``debug_grads`` (``grad_stats`` after the clip), differential groups,
  the flat optimizer with ``debug_grads`` (``grad_stats`` before the
  clip), and the flat optimizer with layerwise groups and k=2;
* the flat update against the port's per-tensor update on a synthetic
  parameter list with every mask (``tests/test_flat_optim.py:63-112``'s
  cases), the float32 rule, the flat EMA, a state of the other setting
  refused by the step;
* the flat state in a checkpoint: resume is exact (distance 0 on the
  CPU), and a checkpoint of one optimizer setting refuses to restore
  into the other.

The flat-vs-per-tensor update is the same arithmetic in another order of
sums: rtol 2e-6, atol 2e-7, as JAX holds its own flat update to its
chain (the group norm 1e-5, the state's ``param_norm`` 1e-6).
"""

import jax
import numpy as np
import pytest
import torch

import torch_port_steps as S
from qavit_tpu.configs import get_preset as jax_get_preset
from qavit_tpu.configs.training import TrainingConfig as JaxTC
from qavit_tpu.train.optim import lr_group_multipliers as jax_multipliers
from qavit_tpu_torch.ckpt import checkpoint as C
from qavit_tpu_torch.ckpt.from_jax import jax_state_dict
from qavit_tpu_torch.configs import get_preset
from qavit_tpu_torch.configs.training import TrainingConfig
from qavit_tpu_torch.nn.models import HQAViT, build_model
from qavit_tpu_torch.train import flat_optim as F
from qavit_tpu_torch.train.optim import (AdamState, adam_init, adamw_update,
                                         apply_clipping, decays,
                                         format_lr_group_table,
                                         make_schedule, tensor_multipliers)
from qavit_tpu_torch.train.state import create_train_state, ema_update
from qavit_tpu_torch.train.steps import make_train_step
from torch_port_common import jax_bundle, port_cfg
from torch_port_common import one_thread  # noqa: F401 (autouse)

LR_PRESETS = ("hqavit_c100_finetune", "hqavit_proc100_hard_finetune",
              "hqavit_tiny_cifar10", "hqavit_tiny_proc10")


def _path(path) -> str:
    return "/".join(getattr(k, "key", str(k)) for k in path)


# ---------------------------------------------------------------------------
# LR groups
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def flagship():
    """(port model, JAX params) of the full-width hqavit_c100."""
    jcfg = jax_get_preset("hqavit_c100").model
    _, variables = jax_bundle(jcfg, seed=0)
    return HQAViT(port_cfg(jcfg)), variables


@pytest.mark.parametrize("mode", ["layerwise", "differential"])
def test_multiplier_of_every_parameter_matches_jax(flagship, mode):
    """Each JAX leaf filled with its JAX multiplier, carried through the
    bridge onto the port's parameters, equals the port's multiplier of
    each parameter, element for element; the accidental match of a CNN
    stem path holding ``stage1`` is JAX's."""
    model, variables = flagship
    tc = TrainingConfig(lr_groups=mode)
    mult = jax_multipliers(JaxTC(lr_groups=mode))
    tree = jax.tree_util.tree_map_with_path(
        lambda p, a: np.full(a.shape, mult(_path(p)), np.float32),
        variables["params"])
    want = jax_state_dict(model, tree, variables["batch_stats"])
    names = [n for n, _ in model.named_parameters()]
    got = tensor_multipliers(names, tc)
    assert len(names) == 815
    for n, m in zip(names, got):
        assert torch.all(want[n] == np.float32(m)), (n, m)
    if mode == "layerwise":
        stem = dict(zip(names, got))["cnn_stem.stage1_conv.weight"]
        assert stem == tc.layer_lr_decay ** 3


@pytest.mark.parametrize("name", LR_PRESETS)
def test_group_table_matches_jax(name):
    """The startup table, one line per multiplier with its count of JAX
    leaves (a stage's blocks one leaf) and the first leaf's module, as
    JAX's ``cli/train.py:244-257`` prints it from its own leaves."""
    jp = jax_get_preset(name)
    _, variables = jax_bundle(jp.model, seed=0)
    mult, groups = jax_multipliers(jp.train), {}
    for p, _ in jax.tree_util.tree_leaves_with_path(variables["params"]):
        groups.setdefault(mult(_path(p)), []).append(_path(p))
    want = [f"LR groups ({jp.train.lr_groups}):"] + [
        f"  x{m:<6g} {len(groups[m]):4d} params  "
        f"(e.g. {groups[m][0].rsplit('/', 1)[0]})"
        for m in sorted(groups, reverse=True)]
    p = get_preset(name)
    model = HQAViT(p.model)
    got = format_lr_group_table([n for n, _ in model.named_parameters()],
                                p.train)
    assert got == want
    assert sum(len(v) for v in groups.values()) == 487


# ---------------------------------------------------------------------------
# whole train steps against JAX's
# ---------------------------------------------------------------------------

STEP_CASES = ("layerwise", "differential", "flat", "flat_layerwise_accum2")


@pytest.fixture(scope="module", params=STEP_CASES)
def runs(request, tiny_cfg):
    """(case, model, configs, {steps: (JAX state, JAX metrics, port
    snapshot, port metrics)}) after 1 and 3 steps from the same start."""
    return S.run_case(request.param, tiny_cfg)


@pytest.mark.parametrize("steps", [1, 3])
def test_train_step_option_matches_jax(runs, steps):
    S.check_case(runs, steps)


# ---------------------------------------------------------------------------
# the flat update against the per-tensor one
# ---------------------------------------------------------------------------

def _synthetic(seed=0):
    """Names that reach every mask: the CNN stem and a stage's two dwconv
    blocks (one pre-clip leaf), a no-weight-decay LayerNorm, a bank write
    projection, the head (LR groups), plain kernels."""
    g = torch.Generator().manual_seed(seed)
    shapes = {"cnn_stem.stem_conv.weight": (8, 4, 3, 3),
              "stage1_blocks.0.dwconv.weight": (16, 1, 3, 3),
              "stage1_blocks.1.dwconv.weight": (16, 1, 3, 3),
              "stage1_blocks.0.quad_block.swa.norm.scale": (16,),
              "stage1_blocks.0.quad_block.swa.qkv.kernel": (16, 48),
              "global_bank.write_norm_scale": (16,),
              "head.kernel": (16, 10)}
    return list(shapes), [torch.randn(s, generator=g) for s in
                          shapes.values()]


@pytest.mark.parametrize("fields", [
    dict(base_lr=3e-3, weight_decay=0.05),
    dict(base_lr=1e-3, weight_decay=0.02, grad_clip_mode="value",
         max_grad_norm=0.01, lr_groups="differential",
         head_lr_multiplier=10.0),
    dict(lr_groups="layerwise")], ids=["default", "value_clip_groups",
                                       "layerwise"])
def test_flat_update_matches_per_tensor(fields):
    tc = TrainingConfig(**fields)
    names, p0 = _synthetic()
    sched = make_schedule(tc, 4)
    p_tree = [p.clone() for p in p0]
    p_flat = [p.clone() for p in p0]
    s_tree = adam_init(p_tree)
    s_flat = F.flat_adam_init(p_flat)
    opt = F.FlatAdamW(names, p_flat, tc)
    for i in range(3):
        g = torch.Generator().manual_seed(7 + i)
        grads = [0.05 * torch.randn(p.shape, generator=g) + 0.2 * p
                 for p in p0]
        clipped, gn = apply_clipping(names, grads, tc)
        adamw_update(p_tree, clipped, s_tree, [decays(n) for n in names],
                     sched(i), tc.weight_decay,
                     multipliers=tensor_multipliers(names, tc))
        new = opt.update(p_flat, [x.clone() for x in grads], s_flat,
                         sched(s_flat.count))
        torch.testing.assert_close(s_flat.grad_norm, gn, rtol=1e-5, atol=0)
        torch.testing.assert_close(new, torch.cat(
            [p.reshape(-1) for p in p_flat]), rtol=0, atol=0)
    for n, a, b in zip(names, p_tree, p_flat):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=2e-6,
                                   atol=2e-7, err_msg=n)
    for a, b in ((s_tree.mu, s_flat.mu), (s_tree.nu, s_flat.nu)):
        np.testing.assert_allclose(
            b.numpy(), torch.cat([x.reshape(-1) for x in a]).numpy(),
            rtol=2e-6, atol=2e-7)
    assert s_flat.count == s_tree.count == 3
    torch.testing.assert_close(
        s_flat.param_norm,
        torch.sqrt(sum((p ** 2).sum() for p in p_flat)), rtol=1e-6, atol=0)
    if tc.lr_groups == "differential":
        moved = [float((b - a).abs().mean()) for a, b in zip(p0, p_flat)]
        assert moved[names.index("head.kernel")] > 3 * moved[
            names.index("stage1_blocks.0.quad_block.swa.qkv.kernel")]


def test_flat_rejects_non_float32():
    with pytest.raises(TypeError, match="float32"):
        F.flat_adam_init([torch.zeros(4, dtype=torch.bfloat16)])
    with pytest.raises(TypeError, match="float32"):
        F.FlatAdamW(["w"], [torch.zeros(4, dtype=torch.bfloat16)],
                    TrainingConfig())


def test_flat_ema_matches_per_tensor(tiny_cfg):
    cfg = port_cfg(tiny_cfg)
    a = create_train_state(build_model(cfg, "cpu", seed=1), True, 0.99)
    b = create_train_state(build_model(cfg, "cpu", seed=1), True, 0.99,
                           flat=True)
    for st in (a, b):
        with torch.no_grad():
            for p in st.model.parameters():
                p.mul_(1.5).add_(0.1)
    ema_update(a.ema_params, a.model, 0.99)
    F.flat_ema_update(b.ema_flat, F.flat_buffer(b.params()), 0.99)
    for n in a.ema_params:
        torch.testing.assert_close(b.ema_params[n], a.ema_params[n],
                                   rtol=1e-6, atol=0)


def test_step_refuses_a_state_of_the_other_setting(tiny_cfg):
    cfg = port_cfg(tiny_cfg)
    x, y = torch.zeros(2, 16, 16, 3), torch.tensor([0, 1])
    for flat in (False, True):
        tc = TrainingConfig(batch_size=2, flat_optimizer=flat)
        state = create_train_state(build_model(cfg, "cpu"), flat=not flat)
        with pytest.raises(TypeError, match=f"flat_optimizer={flat}"):
            make_train_step(cfg, tc, make_schedule(tc, 4))(state, x, y, 0)


# ---------------------------------------------------------------------------
# the flat state in a checkpoint
# ---------------------------------------------------------------------------

def _batches(cfg, n, b=4):
    rs = np.random.RandomState(11)
    return [(torch.from_numpy(rs.standard_normal(
        (b, cfg.img_size, cfg.img_size, 3)).astype(np.float32)),
        torch.from_numpy(rs.randint(0, cfg.num_classes, b)).long())
        for _ in range(n)]


def _tensors(state):
    named = dict(state.model.named_parameters())
    out = {f"p {n}": named[n] for n in state.names}
    out.update({f"b {n}": b for n, b in state.model.named_buffers()})
    out.update({"mu": state.opt.mu, "nu": state.opt.nu,
                "grad_norm": state.opt.grad_norm,
                "param_norm": state.opt.param_norm,
                "ema": state.ema_flat, "bank_count": state.bank_count})
    out.update({f"emab {n}": t for n, t in state.ema_buffers.items()})
    return out


def test_flat_resume_is_exact_and_settings_do_not_mix(tiny_cfg, tmp_path):
    """2 steps, save, restore into a fresh flat state, 2 more: bitwise the
    4 uninterrupted steps (EMA views still views of the flat buffer).  A
    flat checkpoint refuses a per-tensor template and the other way
    round, naming the setting, before anything is copied; its meta tells
    which it is (``written_flat``, how ``cli.evaluate`` builds its
    template)."""
    cfg = port_cfg(tiny_cfg)
    tc = TrainingConfig(batch_size=4, epochs=2, warmup_epochs=1,
                        flat_optimizer=True, lr_groups="layerwise")
    step = make_train_step(cfg, tc, make_schedule(tc, 2))
    batches = _batches(cfg, 4)

    def fresh(seed=0, flat=True):
        return create_train_state(build_model(cfg, "cpu", seed=seed), True,
                                  flat=flat)

    ref = fresh()
    ref_losses = [step(ref, x, y, 7)["loss"] for x, y in batches]
    state = fresh()
    losses = [step(state, x, y, 7)["loss"] for x, y in batches[:2]]
    C.save_train_state(tmp_path / "flat", state, cfg, tc)
    assert C.written_flat(tmp_path / "flat")
    state, _ = C.restore_train_state(tmp_path / "flat", fresh(seed=9))
    losses += [step(state, x, y, 7)["loss"] for x, y in batches[2:]]
    assert torch.equal(torch.stack(losses), torch.stack(ref_losses))
    assert (state.step, state.opt.count) == (ref.step, ref.opt.count) == (
        4, 4)
    got, want = _tensors(state), _tensors(ref)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    name = state.names[0]
    assert state.ema_params[name].data_ptr() == state.ema_flat.data_ptr()

    per_tensor = fresh(flat=False)
    before = {n: p.clone() for n, p in per_tensor.model.named_parameters()}
    with pytest.raises(ValueError, match="flat optimizer's raveled state"):
        C.restore_train_state(tmp_path / "flat", per_tensor)
    assert isinstance(per_tensor.opt, AdamState)
    for n, p in per_tensor.model.named_parameters():
        assert torch.equal(p, before[n]), n
    C.save_train_state(tmp_path / "tree", per_tensor, cfg,
                       tc.replace(flat_optimizer=False))
    assert not C.written_flat(tmp_path / "tree")
    with pytest.raises(ValueError, match="per-tensor optimizer's state"):
        C.restore_train_state(tmp_path / "tree", fresh())
