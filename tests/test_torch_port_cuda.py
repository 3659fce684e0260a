"""Tests of the port that need an NVIDIA GPU with the CUDA toolkit
(marked ``cuda``; without CUDA they skip).  On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Each unit kernel against its plain version within the stated tolerance
(fused_kernels.TOLERANCE) at the hqavit_c100 and the hqavit_proc_tin
geometries (16 tokens in one SWA window; 64 in four), a full-width
hqavit_c100 forward that launches every kernel 8 times and a full-depth
hqavit_proc_tin forward that launches each forward unit 12 times, both
matching the plain path's logits, each
unit's train-mode forward and backward kernel against the plain version
and autograd (fused_kernels.GRAD_TOLERANCE; the bf16 forwards and
backwards through their tensor-core entries), the n=16 bf16 CGA forward
(eval and train) and backward routes, and one full-width train
step that launches every forward and backward kernel 8 times; the
flash-attention kernel against its plain version at the 224 shapes and
where Nkv and D are not multiples of 16, and a full-depth
qavit_224_v1_proc forward that launches it 16 times and matches the plain
path's logits; the tensor-core primitives' self-test (ldmatrix ->
mma.sync against A @ B) and the n=64 bf16 SWA, MSDA, CGA and cross/tail
kernels with a short bank and with their NaN guard tripped; the four
n=64 bf16 backwards on two-CTA clusters (their occupancy and gradients on
two launch grids); the four n=64 bf16 train-mode forwards at B=128 and
B=1024 with masks on (the SWA, MSDA and cross/tail ones on two-CTA
clusters)."""

from unittest import mock

import pytest
import torch

from qavit_tpu_torch.configs import get_preset
from qavit_tpu_torch.kernels import flash_attention as FA
from qavit_tpu_torch.kernels import fused_kernels as K
from qavit_tpu_torch.kernels import mma_selftest as MS
from qavit_tpu_torch.kernels.fused_params import QuadBlockParams
from qavit_tpu_torch.kernels.fused_ref import make_geom
from qavit_tpu_torch.nn.layers import init_weights, param_tree
from qavit_tpu_torch.nn.models import build_model

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _units_match_plain(cuda, preset, dtype):
    cfg = get_preset(preset).model
    g = make_geom(cfg)
    gen = torch.Generator().manual_seed(0)
    p = param_tree(init_weights(QuadBlockParams(cfg, g), gen).to(cuda))
    bk, bv = ((torch.randn(1, g.bank_s, g.c, generator=gen) * 0.5).to(cuda)
              for _ in range(2))
    x = torch.randn(64, g.n, g.c, generator=gen).to(cuda, dtype)
    with torch.inference_mode():
        o, xn = K.unit_swa(p, x, bk, bv, g, dtype)
        ro, rxn = K.swa_plain(p, x, bk, bv, g, dtype)
        m = K.unit_msda(p, rxn, bk, bv, g, dtype)
        c = K.unit_cga(p, rxn, bk, bv, g, dtype)
        rm = K.msda_plain(p, rxn, bk, bv, g, dtype)
        rc = K.cga_plain(p, rxn, bk, bv, g, dtype)
        y = K.unit_cross_tail(p, x, rxn, ro, rm, rc, bk, bv, g, dtype)
        ry = K.cross_tail_plain(p, x, rxn, ro, rm, rc, bk, bv, g, dtype)
        torch.cuda.synchronize()
    for out, ref in ((o, ro), (xn, rxn), (m, rm), (c, rc), (y, ry)):
        assert K.within_tolerance(out, ref), K.max_abs_err(out, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_units_match_plain_on_the_card(cuda, dtype):
    _units_match_plain(cuda, "hqavit_c100", dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_multiwindow_units_match_plain_on_the_card(cuda, dtype):
    """The n=64 geometry (four SWA windows, 40 pooled MSDA rows)."""
    _units_match_plain(cuda, "hqavit_proc_tin", dtype)


def test_multiwindow_forward_launches_each_unit_per_block(cuda):
    """hqavit_proc_tin: 12 launches of each forward unit per forward, no
    backward or flash launch, logits as the plain path's."""
    cfg = get_preset("hqavit_proc_tin").model
    model = build_model(cfg, cuda, seed=0)
    x = torch.randn(8, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    x = x.to(cuda)
    K.reset_launches()
    FA.reset_launches()
    with torch.inference_mode():
        logits, _ = model(x)
        counts = {**K.LAUNCHES, **FA.LAUNCHES}
        with mock.patch.multiple(K, **K.PLAIN):
            ref, _ = model(x)
    assert counts == {n: cfg.depth if n in K.UNITS else 0 for n in counts}
    assert cfg.depth == 12 and logits.shape == (8, cfg.num_classes)
    err = (logits - ref).abs().max().item()
    assert err <= 2.0 ** -4 * ref.abs().max().item(), err


def test_forward_launches_each_kernel_per_block(cuda):
    cfg = get_preset("hqavit_c100").model
    model = build_model(cfg, cuda, seed=0)
    x = torch.randn(8, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    x = x.to(cuda)
    K.reset_launches()
    with torch.inference_mode():
        logits, _ = model(x)
        counts = dict(K.LAUNCHES)
        with mock.patch.multiple(K, **K.PLAIN):
            ref, _ = model(x)
    assert counts == {name: cfg.depth if name in K.UNITS else 0
                      for name in K.LAUNCHES}
    assert logits.shape == (8, cfg.num_classes)
    err = (logits - ref).abs().max().item()
    assert err <= 2.0 ** -4 * ref.abs().max().item(), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("unit", list(K.UNITS))
def test_backward_kernels_match_autograd_on_the_card(cuda, unit, dtype):
    from qavit_tpu_torch.kernels import build
    from qavit_tpu_torch.kernels import fused_ref as R
    from qavit_tpu_torch.kernels import unit_checks as UC
    from qavit_tpu_torch.nn.bank import GlobalBankParams

    cfg = get_preset("hqavit_c100").model
    g = make_geom(cfg)
    gen = torch.Generator().manual_seed(0)
    p = param_tree(init_weights(QuadBlockParams(cfg, g), gen).to(cuda))
    bank = init_weights(GlobalBankParams(cfg.bank, g.c), gen).to(cuda)
    bankp = {k: v.detach() for k, v in bank.write_params().items()}
    rows = tuple((torch.randn(1, g.bank_s, g.c, generator=gen) * 0.5).to(
        cuda) for _ in range(2))
    x = torch.randn(64, g.n, g.c, generator=gen).to(cuda, dtype)
    batch = UC.unit_inputs(p, g, dtype, x, rows)[unit]
    lib = K.bind(build.load().lib)
    train = K.UnitTrain(R.block_rng(3, 0.1, 0.1), bankp)
    grid = K.train_grid(cuda, 64)
    cots = UC.random_cotangents(unit, batch, dtype, gen)
    K.reset_launches()
    r = UC.check_unit(lib, unit, p, train, batch, g, dtype, grid, cots,
                      torch.cuda.current_stream().cuda_stream)
    assert r.ok, r
    # the route: every bf16 forward and backward on the tensor cores
    entry = K.bwd_entry(unit, g, dtype)
    mma = dtype == torch.bfloat16
    assert entry.endswith("_mma") == mma
    assert K.ROUTES[entry] == 1
    assert K.ROUTES[unit + ("_mma" if mma else "")] == 1


def test_train_step_launches_each_kernel_per_block(cuda):
    from qavit_tpu_torch.train.optim import make_schedule
    from qavit_tpu_torch.train.state import create_train_state
    from qavit_tpu_torch.train.steps import make_train_step

    preset = get_preset("hqavit_c100")
    cfg, tc = preset.model, preset.train
    model = build_model(cfg, cuda, seed=0)
    state = create_train_state(model, tc.use_ema, tc.ema_decay)
    step = make_train_step(cfg, tc, make_schedule(tc, 100))
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(16, 32, 32, 3, generator=gen).to(cuda)
    y = torch.randint(0, cfg.num_classes, (16,), generator=gen).to(cuda)
    K.reset_launches()
    m = step(state, x, y, 0)
    assert dict(K.LAUNCHES) == {n: cfg.depth for n in K.LAUNCHES}
    assert int(state.bank_count) == 3 * cfg.depth
    assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nkv,broadcast", [(80, False), (16, True),
                                           (144, False)])
def test_flash_kernel_matches_plain_on_the_card(cuda, nkv, broadcast, dtype,
                                                rate):
    gen = torch.Generator().manual_seed(2)
    b, nq, h, d = 32, 196, 4, 48 if nkv < 144 else 64
    q = torch.randn(b, nq, h, d, generator=gen).to(cuda, dtype)
    k, v = (torch.randn(1 if broadcast else b, nkv, h, d, generator=gen)
            .to(cuda, dtype).expand(b, -1, -1, -1) for _ in range(2))
    with torch.inference_mode():
        out = FA.flash_attention(q, k, v, rate, 99)
        torch.cuda.synchronize()
        ref = FA.plain(q, k, v, rate, 99)
    assert K.within_tolerance(out, ref), K.max_abs_err(out, ref)


def test_224_forward_launches_the_flash_kernel(cuda):
    cfg = get_preset("qavit_224_v1_proc").model
    model = build_model(cfg, cuda, seed=0)
    x = torch.randn(8, 224, 224, 3,
                    generator=torch.Generator().manual_seed(1)).to(cuda)
    K.reset_launches()
    FA.reset_launches()
    with torch.inference_mode():
        logits, _ = model(x)
        counts = {**K.LAUNCHES, **FA.LAUNCHES}
        with mock.patch.object(FA, "flash_attention", FA.plain):
            ref, _ = model(x)
    assert counts == {n: 2 * cfg.depth if n == "flash_attention" else 0
                      for n in counts}
    assert logits.shape == (8, cfg.num_classes)
    err = (logits - ref).abs().max().item()
    assert err <= 2.0 ** -4 * ref.abs().max().item(), err


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("nkv,d", [(40, 40), (33, 36)])
def test_flash_kernel_padding_on_the_card(cuda, nkv, d, rate):
    """bf16 Nkv and D that are not multiples of 16 (zero padding, masked
    keys); at D=36 every operand takes the plain loads, not cp.async."""
    gen = torch.Generator().manual_seed(3)
    q = torch.randn(32, 196, 4, d, generator=gen).to(cuda, torch.bfloat16)
    k, v = (torch.randn(32, nkv, 4, d, generator=gen).to(cuda, torch.bfloat16)
            for _ in range(2))
    with torch.inference_mode():
        out = FA.flash_attention(q, k, v, rate, 99)
        torch.cuda.synchronize()
        ref = FA.plain(q, k, v, rate, 99)
    assert K.within_tolerance(out, ref), K.max_abs_err(out, ref)


def test_mma_fragments_on_the_card(cuda):
    """ldmatrix (and .trans) -> mma.sync m16n8k16 against A @ B."""
    from qavit_tpu_torch.kernels import build

    lib = K.bind(build.load().lib)
    rows, ok = MS.check(lib, seed=0, device=cuda,
                        stream=torch.cuda.current_stream().cuda_stream)
    assert ok, rows


def _tin_msda_inputs(cuda, bank_s, seed):
    cfg = get_preset("hqavit_proc_tin").model
    g = make_geom(cfg)._replace(bank_s=bank_s)
    gen = torch.Generator().manual_seed(seed)
    p = param_tree(init_weights(QuadBlockParams(cfg, g), gen).to(cuda))
    bk, bv = ((torch.randn(1, bank_s, g.c, generator=gen) * 0.5).to(cuda)
              for _ in range(2))
    xn = torch.randn(64, g.n, g.c, generator=gen).to(cuda, torch.bfloat16)
    return g, p, bk, bv, xn


def test_multiwindow_msda_short_bank_on_the_card(cuda):
    """The n=64 bf16 MSDA kernel with 12 bank rows (44 keys a head, the
    last key tile's padding masked)."""
    g, p, bk, bv, xn = _tin_msda_inputs(cuda, 12, 4)
    with torch.inference_mode():
        out = K.unit_msda(p, xn, bk, bv, g, torch.bfloat16)
        torch.cuda.synchronize()
        ref = K.msda_plain(p, xn, bk, bv, g, torch.bfloat16)
    assert K.within_tolerance(out, ref), K.max_abs_err(out, ref)


def test_multiwindow_msda_nan_guard_bf16_on_the_card(cuda):
    """A NaN in one sample: every sample's output is proj(0), as plain."""
    g, p, bk, bv, xn = _tin_msda_inputs(cuda, 16, 5)
    xn[9, 3, 5] = float("nan")
    with torch.inference_mode():
        out = K.unit_msda(p, xn, bk, bv, g, torch.bfloat16)
        torch.cuda.synchronize()
        ref = K.msda_plain(p, xn, bk, bv, g, torch.bfloat16)
    assert torch.equal(out, ref)


def _tin_unit(cuda, unit, bank_s, seed, nan_at=None):
    """(kernel output, plain output) of the n=64 bf16 SWA (x), CGA (xn) or
    cross/tail (xn, the cross branch's q input) unit, a NaN put at
    ``nan_at`` of that input."""
    g, p, bk, bv, x = _tin_msda_inputs(cuda, bank_s, seed)
    dtype = torch.bfloat16
    with torch.inference_mode():
        if unit == "cga":
            if nan_at is not None:
                x[nan_at] = float("nan")
            K.reset_launches()
            out = K.unit_cga(p, x, bk, bv, g, dtype)
            torch.cuda.synchronize()
            assert K.ROUTES["unit_cga_mma"] == 1
            return out, K.cga_plain(p, x, bk, bv, g, dtype)
        if unit == "swa":
            if nan_at is not None:
                x[nan_at] = float("nan")
            out = K.unit_swa(p, x, bk, bv, g, dtype)
            torch.cuda.synchronize()
            return out, K.swa_plain(p, x, bk, bv, g, dtype)
        o, xn = K.swa_plain(p, x, bk, bv, g, dtype)
        args = [x, xn.clone(), o, K.msda_plain(p, xn, bk, bv, g, dtype),
                K.cga_plain(p, xn, bk, bv, g, dtype), bk, bv, g, dtype]
        if nan_at is not None:
            args[1][nan_at] = float("nan")
        out = K.unit_cross_tail(p, *args)
        torch.cuda.synchronize()
        return out, K.cross_tail_plain(p, *args)


@pytest.mark.parametrize("unit", ["swa", "cross_tail", "cga"])
def test_multiwindow_mma_short_bank_on_the_card(cuda, unit):
    """The n=64 bf16 SWA, CGA and cross/tail kernels with 12 bank rows."""
    out, ref = _tin_unit(cuda, unit, 12, 6)
    for o, r in zip(out if unit == "swa" else (out,),
                    ref if unit == "swa" else (ref,)):
        assert K.within_tolerance(o, r), K.max_abs_err(o, r)


@pytest.mark.parametrize("unit", ["swa", "cross_tail", "cga"])
def test_multiwindow_mma_nan_guard_bf16_on_the_card(cuda, unit):
    """A NaN in one sample: SWA's and CGA's output is proj(0) in every
    sample and SWA's xn keeps the NaN row; the cross/tail output is
    finite, every sample's cross attention zero, as plain."""
    out, ref = _tin_unit(cuda, unit, 16, 7, (9, 3, 5))
    if unit == "swa":
        assert torch.equal(out[0], ref[0])
        out, ref = out[1], ref[1]
    nan = torch.isnan(ref)
    assert torch.equal(torch.isnan(out), nan)
    assert K.within_tolerance(out[~nan], ref[~nan])


def _c100_cga_inputs(cuda, b, seed):
    from qavit_tpu_torch.kernels import fused_ref as R
    from qavit_tpu_torch.kernels import unit_checks as UC
    from qavit_tpu_torch.nn.bank import GlobalBankParams

    cfg = get_preset("hqavit_c100").model
    g = make_geom(cfg)
    gen = torch.Generator().manual_seed(seed)
    p = param_tree(init_weights(QuadBlockParams(cfg, g), gen).to(cuda))
    bank = init_weights(GlobalBankParams(cfg.bank, g.c), gen).to(cuda)
    bankp = {k: v.detach() for k, v in bank.write_params().items()}
    rows = tuple((torch.randn(1, g.bank_s, g.c, generator=gen) * 0.5).to(
        cuda) for _ in range(2))
    x = torch.randn(b, g.n, g.c, generator=gen).to(cuda, torch.bfloat16)
    batch = UC.unit_inputs(p, g, torch.bfloat16, x, rows)["unit_cga"]
    train = K.UnitTrain(R.block_rng(seed, 0.1, 0.1), bankp)
    return g, p, batch, train, gen


@pytest.mark.parametrize("train", [False, True])
def test_n16_cga_forward_takes_the_tensor_cores(cuda, train):
    """The n=16 bf16 CGA forward at hqavit_c100's widths, eval and train,
    over 63 samples (a short last tile) through ``cga_mma_kernel`` only,
    within the stated tolerances of the plain version."""
    from qavit_tpu_torch.kernels import build
    from qavit_tpu_torch.kernels import unit_checks as UC

    g, p, batch, tr, _ = _c100_cga_inputs(cuda, 63, 11)
    dtype = torch.bfloat16
    lib = K.bind(build.load().lib)
    stream = torch.cuda.current_stream().cuda_stream
    K.reset_launches()
    with torch.inference_mode():
        if train:
            *outs, _ = K.launch_cga(lib, p, *batch, g, dtype, stream, tr,
                                    K.train_grid(cuda, 63))
            ref = K.cga_plain(p, *batch, g, dtype, tr)
            out_err, part_err = UC.forward_errors(
                [outs[0], outs[1][0], outs[1][1]], ref, 1)
            assert out_err <= K.TOLERANCE[dtype], out_err
            assert part_err <= UC.PARTIAL_TOLERANCE, part_err
        else:
            out = K.unit_cga(p, *batch, g, dtype)
            torch.cuda.synchronize()
            ref = K.cga_plain(p, *batch, g, dtype)
            assert K.within_tolerance(out, ref), K.max_abs_err(out, ref)
    assert (K.ROUTES["unit_cga_mma"], K.ROUTES["unit_cga"]) == (1, 0)


def test_n16_cga_backward_takes_the_tensor_cores(cuda):
    """The n=16 bf16 CGA backward at hqavit_c100's widths through
    ``cga_bwd_mma_kernel``, its gradients against autograd through the
    plain version (GRAD_TOLERANCE), over 63 samples (a short last pass)."""
    from qavit_tpu_torch.kernels import build
    from qavit_tpu_torch.kernels import unit_checks as UC

    g, p, batch, tr, gen = _c100_cga_inputs(cuda, 63, 12)
    dtype = torch.bfloat16
    lib = K.bind(build.load().lib)
    cots = UC.random_cotangents("unit_cga", batch, dtype, gen)
    K.reset_launches()
    r = UC.check_unit(lib, "unit_cga", p, tr, batch, g, dtype,
                      K.train_grid(cuda, 63), cots,
                      torch.cuda.current_stream().cuda_stream)
    assert r.ok, r
    assert (K.ROUTES["unit_cga_bwd_mma"], K.ROUTES["unit_cga_bwd"]) == (1, 0)


@pytest.mark.parametrize("pipeline", ["proc100_hard_hqa", "proc_stl"])
def test_augment_on_the_card_matches_the_cpu(cuda, pipeline):
    """``apply_augment`` on the card against the CPU with the same drawn
    parameters (normalised output within 2e-3, the composed pipeline's
    tolerance in test_torch_port_data.py), at B=256; the draws are
    deterministic in the card's generator."""
    from qavit_tpu_torch.data import augment as A
    from qavit_tpu_torch.data.pipelines import get_pipeline

    aug = get_pipeline(pipeline).aug
    size = 96 if pipeline == "proc_stl" else 32
    imgs = torch.randint(0, 256, (256, size, size, 3), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(1))
    params = A.draw_params(aug, 256,
                           torch.Generator(device=cuda).manual_seed(0))
    got = A.apply_augment(imgs.to(cuda), params, aug)
    want = A.apply_augment(imgs, {k: v.cpu() for k, v in params.items()},
                           aug)
    assert got.device.type == "cuda" and bool(torch.isfinite(got).all())
    assert (got.cpu() - want).abs().max().item() <= 2e-3
    again = A.augment_batch(imgs.to(cuda), aug,
                            torch.Generator(device=cuda).manual_seed(0))
    assert torch.equal(again, got)


@pytest.mark.parametrize("unit", ["unit_swa", "unit_msda", "unit_cga",
                                  "unit_cross_tail"])
def test_n64_cluster_backward_on_the_card(cuda, unit):
    """The n=64 bf16 backwards on clusters of two CTAs (CGA and cross/tail
    one a sample, MSDA a sample a CTA, SWA two windows a pass): the CTAs
    resident per SM their design needs (CGA two, the others one), and
    their gradients against autograd through the plain version
    (GRAD_TOLERANCE) with masks on over 9 samples, on the train grid's
    clusters and on three SMs' (clusters walking several samples or
    passes, one ending short), each launch through its ``_bwd_mma64``
    entry."""
    import ctypes

    from qavit_tpu_torch.kernels import build
    from qavit_tpu_torch.kernels import fused_ref as R
    from qavit_tpu_torch.kernels import unit_checks as UC
    from qavit_tpu_torch.nn.bank import GlobalBankParams

    cfg = get_preset("hqavit_proc_tin").model
    g = make_geom(cfg)
    gen = torch.Generator().manual_seed(21)
    p = param_tree(init_weights(QuadBlockParams(cfg, g), gen).to(cuda))
    bank = init_weights(GlobalBankParams(cfg.bank, g.c), gen).to(cuda)
    bankp = {k: v.detach() for k, v in bank.write_params().items()}
    rows = [(torch.randn(1, g.bank_s, g.c, generator=gen) * 0.5).to(cuda)
            for _ in range(2)]
    dtype = torch.bfloat16
    x = torch.randn(9, g.n, g.c, generator=gen).to(cuda, dtype)
    batch = UC.unit_inputs(p, g, dtype, x, rows)[unit]
    tr = K.UnitTrain(R.block_rng(22, 0.1, 0.1), bankp)
    cots = UC.random_cotangents(unit, batch, dtype, gen)
    lib = K.bind(build.load().lib)
    entry = f"{unit}_bwd_mma64"
    per_sm, clusters = ctypes.c_int(), ctypes.c_int()
    assert getattr(lib, f"qv_{entry}_occupancy")(
        ctypes.byref(per_sm), ctypes.byref(clusters)) == 0
    assert per_sm.value >= K.CLUSTER_BWD[entry] and clusters.value > 0
    for grid in (K.train_grid(cuda, 9), K.Grid(3, 12)):
        K.reset_launches()
        r = UC.check_unit(lib, unit, p, tr, batch, g, dtype, grid, cots,
                          torch.cuda.current_stream().cuda_stream)
        assert r.ok, r
        assert K.ROUTES[entry] == 1, K.ROUTES


@pytest.mark.parametrize("b", [128, 1024])
@pytest.mark.parametrize("unit", ["unit_swa", "unit_msda", "unit_cga",
                                  "unit_cross_tail"])
def test_n64_train_forward_on_the_card(cuda, unit, b):
    """The n=64 bf16 train-mode forwards (CGA: the projected bank on the
    tensor cores, both dropouts as products, part_k formed after the
    blocks' sum; SWA, MSDA and cross/tail: a two-CTA cluster a sample, two
    CTAs resident an SM) against the plain version with masks on at
    B=128 and B=1024: outputs within TOLERANCE[bf16] and bank partials
    within PARTIAL_TOLERANCE of max|plain|, one launch through the unit's
    ``_mma_train64`` entry and no other."""
    import ctypes

    from qavit_tpu_torch.kernels import build
    from qavit_tpu_torch.kernels import fused_ref as R
    from qavit_tpu_torch.kernels import unit_checks as UC
    from qavit_tpu_torch.nn.bank import GlobalBankParams

    cfg = get_preset("hqavit_proc_tin").model
    g = make_geom(cfg)
    gen = torch.Generator().manual_seed(23)
    p = param_tree(init_weights(QuadBlockParams(cfg, g), gen).to(cuda))
    bank = init_weights(GlobalBankParams(cfg.bank, g.c), gen).to(cuda)
    bankp = {k: v.detach() for k, v in bank.write_params().items()}
    rows = [(torch.randn(1, g.bank_s, g.c, generator=gen) * 0.5).to(cuda)
            for _ in range(2)]
    dtype = torch.bfloat16
    x = torch.randn(b, g.n, g.c, generator=gen).to(cuda, dtype)
    batch = UC.unit_inputs(p, g, dtype, x, rows)[unit]
    tr = K.UnitTrain(R.block_rng(24, 0.1, 0.1), bankp)
    lib = K.bind(build.load().lib)
    entry = f"{unit}_mma_train64"
    if entry in K.CLUSTER_FWD:
        per_sm, clusters = ctypes.c_int(), ctypes.c_int()
        assert getattr(lib, f"qv_{entry}_occupancy")(
            ctypes.byref(per_sm), ctypes.byref(clusters)) == 0
        assert per_sm.value >= K.CLUSTER_FWD[entry] and clusters.value > 0
    K.reset_launches()
    *outs, ws = K._FWD[unit](lib, p, *batch, g, dtype,
                             torch.cuda.current_stream().cuda_stream, tr,
                             K.train_grid(cuda, b))
    torch.cuda.synchronize()
    assert K.ROUTES[entry] == 1 and sum(K.ROUTES.values()) == 1, K.ROUTES
    assert int(ws[1]) == 0
    with torch.no_grad():
        ref = K.PLAIN[unit](p, *batch, g, dtype, tr)
    ref = ref if isinstance(ref, tuple) else (ref,)
    n = K._N_DIFF_OUT[unit]
    parts = list(outs[n]) if len(outs) > n else []
    out_err, part_err = UC.forward_errors(list(outs[:n]) + parts, ref, n)
    assert out_err <= K.TOLERANCE[dtype], out_err
    assert part_err <= UC.PARTIAL_TOLERANCE, part_err
