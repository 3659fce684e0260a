"""The eval-mode VJP of the four fused units (what Grad-CAM and the verify
sweep differentiate on the card), with the kernels' own source compiled
for the host with g++ against tests/cuda_emulation/qv_emulate.h and driven
through the same ctypes launch functions the card uses.

Each unit's eval forward kernel (the kernel an inference forward takes)
and its backward kernel in eval mode (``d.train`` off: no masks, no bank
partials, JAX's ``make_cores(train=False)``) are held against autograd
through the plain eval version: outputs within ``fused_kernels.TOLERANCE``,
d(inputs), d(bank rows) and the weight gradients within
``fused_kernels.GRAD_TOLERANCE``.  At n=16: hqavit_c100's width in bf16
(the tensor-core kernels; B=1 and B=3, a short tile of four samples, the
backward on two blocks) and the narrow width in float32 (the CUDA-core
kernels, B=3).  At n=64: hqavit_tiny_in's width in bf16 (two-CTA
clusters; B=1 and B=2).  Then the autograd path the card takes
(``_eval_unit`` -> ``_EvalUnit``): gradients flow where the plain launch
leaves none, the outputs equal the inference-mode launch bit for bit,
which takes the same C entry and no backward; float32 at n=64 raises
before any launch."""

from unittest import mock

import pytest
import torch

from qavit_tpu_torch.kernels import fused_kernels as K
from qavit_tpu_torch.kernels import unit_checks as C
from torch_port_common import one_thread  # noqa: F401 (autouse)
from torch_port_emulation import _case, emulation_library
from torch_port_emulation import two_cores  # noqa: F401 (autouse)

# (width, dtype, batch): see the module docstring
CASES = {"n16_bf16_B1": ("flagship_width", torch.bfloat16, 1),
         "n16_bf16_B3": ("flagship_width", torch.bfloat16, 3),
         "n16_f32_narrow_B3": ("tiny", torch.float32, 3),
         "n64_bf16_B1": ("tin", torch.bfloat16, 1),
         "n64_bf16_B2": ("tin", torch.bfloat16, 2)}


@pytest.fixture(scope="module")
def emu_lib(tmp_path_factory):
    return emulation_library(tmp_path_factory)


def _grid(g, b):
    """The train grid's blocks on a host of 2 SMs at n=16 and 4 at n=64
    (at most one a sample, as ``train_grid`` gives on the card)."""
    return K.Grid(min(2 if g.n == 16 else 4, b), 2)


def _inputs(case_id, unit):
    width, dtype, b = CASES[case_id]
    g, p, _, rows, x = _case(width)
    g = g._replace(dropout=0.0)
    batch = C.unit_inputs(p, g, dtype, x[:b].to(dtype), rows)[unit]
    cots = C.random_cotangents(unit, batch, dtype,
                               torch.Generator().manual_seed(7))
    return g, p, dtype, batch, cots


@pytest.mark.parametrize("case_id", list(CASES))
@pytest.mark.parametrize("unit", list(K.UNITS))
def test_eval_backward_kernel(emu_lib, unit, case_id):
    """The eval forward kernel and the eval-mode backward kernel against
    autograd through the plain eval version."""
    g, p, dtype, batch, cots = _inputs(case_id, unit)
    r = C.check_unit(emu_lib, unit, p, None, batch, g, dtype,
                     _grid(g, batch[0].shape[0]), cots)
    assert r.ok, r


@pytest.mark.parametrize("unit", list(K.UNITS))
def test_eval_forward_under_autograd(emu_lib, unit):
    """Through ``_eval_unit`` with grad on, the unit is one autograd node:
    the gradients reach the tokens, the bank rows and the weights (the
    plain launch leaves the outputs without a graph, so a gradient through
    an eval forward stopped at the first block), hold against autograd of
    the plain version, and the outputs equal the inference-mode launch's
    bit for bit; under ``inference_mode`` the same C entry runs once and
    no backward."""
    g, p, dtype, batch, cots = _inputs("n16_bf16_B1", unit)
    n = K._N_DIFF_OUT[unit]
    with mock.patch.object(K, "_cuda", lambda t, name: (emu_lib, None)), \
            mock.patch.object(K, "train_grid",
                              lambda dev, b: _grid(g, b)):
        K.reset_launches()
        with torch.inference_mode():
            ref_out = K._eval_unit(unit, p, batch, g, dtype)
        inf_routes = {k: v for k, v in K.ROUTES.items() if v}
        inf_launches = {k: v for k, v in K.LAUNCHES.items() if v}
        route = {"unit_swa": K.swa_route, "unit_msda": K.msda_route,
                 "unit_cga": K.cga_route,
                 "unit_cross_tail": K.cross_tail_route}[unit](g, dtype)
        assert inf_routes == {route: 1}, inf_routes
        assert inf_launches == {unit: 1}, inf_launches

        leaves = [t.detach().clone().requires_grad_() for t in batch]
        K.reset_launches()
        out = K._eval_unit(unit, p, leaves, g, dtype)
        outs = out if isinstance(out, tuple) else (out,)
        assert all(o.requires_grad for o in outs)
        for o, r in zip(outs, ref_out if n > 1 else (ref_out,)):
            assert torch.equal(o, r)
        params = K.unit_params(unit, p)
        got = torch.autograd.grad(outs, leaves + [t for _, t in params],
                                  cots)
        assert {k: v for k, v in K.ROUTES.items() if v} == {
            **inf_routes, K.bwd_entry(unit, g, dtype): 1}
        assert {k: v for k, v in K.LAUNCHES.items() if v} == {
            unit: 1, f"{unit}_bwd": 1}

    ref_leaves = [t.detach().clone().requires_grad_() for t in batch]
    weights = [t.detach().clone().requires_grad_() for _, t in params]
    pw = C._with(p, [path for path, _ in params], weights)
    ref = K.PLAIN[unit](pw, *ref_leaves, g, dtype)
    ref = ref if isinstance(ref, tuple) else (ref,)
    want = torch.autograd.grad(ref, ref_leaves + weights, cots,
                               allow_unused=True)
    pairs = [(a, torch.zeros_like(a) if b is None else b)
             for a, b in zip(got, want)]
    _, rel, ok = K.compare_grads(pairs, dtype)
    assert ok, (unit, rel)


def test_eval_vjp_float32_at_n64_raises_before_a_launch():
    """Float32 at n=64 has no backward kernel (ROADMAP queue 2 item 2d):
    an eval forward that autograd would differentiate raises, naming it,
    before any launch; without grad it launches as before."""
    g, p, _, rows, x = _case("tin")
    batch = C.unit_inputs(p, g, torch.float32, x[:1], rows)["unit_swa"]
    leaves = [batch[0].clone().requires_grad_()] + list(batch[1:])
    K.reset_launches()
    with pytest.raises(ValueError, match="item 2d"):
        K._eval_unit("unit_swa", p, leaves, g, torch.float32)
    assert not any(K.ROUTES.values()) and not any(K.LAUNCHES.values())
    assert "float32 at n=64" in K.eval_vjp_error("unit_cga", g,
                                                 torch.float32)
    assert K.eval_vjp_error("unit_cga", g, torch.bfloat16) is None
