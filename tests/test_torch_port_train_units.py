"""The port's plain units in training against the JAX package, on the
same seed-made weights, inputs, masks and cotangents: per unit the
outputs, the bank-write partials and the gradients (every parameter the
unit differentiates into, the bank rows and every batch input) against
``jax.vjp`` of the JAX unit twins (``qavit_tpu/kernels/fused_ref.py``), at
the tiny width and the hqavit_c100 width, at dropout 0 and with dropout
and drop-path on (both sides fed the arrays of the JAX package's
``make_block_masks``), and at n=64 in four SWA windows (the narrow
hqavit_tiny_in geometry, torch_port_common.narrow_tiny_in); and one fused
block in training (three bank writes) against the JAX package's Pallas
units run in interpret mode, forward and gradients, at dropout 0, at the
tiny width and at the narrow n=64 geometry.

Tolerance: float32, rtol 1e-4 / atol 1e-5 against max|JAX| for outputs
and gradients (torch_port_common.F32: the same algorithm, sums in another
order).  A gradient that is zero in exact arithmetic holds only roundoff
(the cross branch's key bias: a vector added to every key shifts all of a
query's scores alike, which the softmax ignores), so a gradient's atol
scale is at least 1e-2 of the unit's largest gradient."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qavit_tpu.kernels import fused_ref as RJ
from qavit_tpu_torch.ckpt.from_jax import load_jax_params
from qavit_tpu_torch.kernels import fused_kernels as K
from qavit_tpu_torch.kernels import fused_ref as RT
from qavit_tpu_torch.kernels.fused_params import QuadBlockParams
from qavit_tpu_torch.nn.layers import param_tree
from torch_port_common import (block_tree, flagship_width_depth2, jax_bundle,
                               narrow_tiny_in, port_cfg, to_np)
from torch_port_common import one_thread  # noqa: F401 (autouse)

B = 3


def _close(port, ref, what="", floor=0.0):
    """float32 port value against the JAX value: rtol 1e-4, and an atol
    of 1e-5 x max(max|JAX|, floor) (the same algorithm, sums in another
    order)."""
    p, r = to_np(port), to_np(ref)
    assert p.shape == r.shape, (what, p.shape, r.shape)
    scale = max(float(np.abs(r).max()), floor, 1e-30)
    np.testing.assert_allclose(p, r, rtol=1e-4, atol=1e-5 * scale,
                               err_msg=what)


_CASES = {}


def _make_case(which, tiny_cfg):
    if which in _CASES:
        return _CASES[which]
    jcfg = {"tiny": lambda: tiny_cfg.replace(attn_impl="fused_block"),
            "flagship_width": flagship_width_depth2,
            "narrow_tin": narrow_tiny_in}[which]()
    _, variables = jax_bundle(jcfg, seed=1)
    pj = block_tree(variables)
    bankp = {k: v for k, v in variables["params"]["global_bank"].items()
             if k.startswith("write_")}
    cfg = port_cfg(jcfg)
    gt = RT.make_geom(cfg)
    pt = param_tree(load_jax_params(QuadBlockParams(cfg, gt), pj))
    rs = np.random.RandomState(2)
    s, c = gt.bank_s, gt.c
    bank = [rs.standard_normal((1, s, c)).astype(np.float32) * 0.5
            for _ in range(2)]
    x = rs.standard_normal((B, gt.n, c)).astype(np.float32)
    cots = [rs.standard_normal((B, gt.n, c)).astype(np.float32)
            for _ in range(2)]
    _CASES[which] = (jcfg, RJ.make_geom(jcfg), gt, pj, pt, bankp, bank, x,
                     cots)
    return _CASES[which]


@pytest.fixture(scope="module",
                params=["tiny", "flagship_width", "narrow_tin"])
def case(request, tiny_cfg):
    return _make_case(request.param, tiny_cfg)


def _jax_masks(gj, rate, dpr):
    g = gj._replace(dropout=rate)
    m = RJ.make_block_masks(jax.random.PRNGKey(3), B, g, dpr, True)
    return g, m, {k: None if v is None else torch.from_numpy(
        np.array(v)) for k, v in m.items()}


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


_DW = ("ccf_ffn", "dwconv", "dwconv", "weight")


def _jpath(path):
    """The JAX path of a port parameter (the depthwise conv's OIHW
    ``weight`` is the HWIO ``kernel`` there)."""
    return path[:-1] + ("kernel",) if path == _DW else path


def _to_port(path, a):
    a = np.asarray(a, np.float32)
    return a.transpose(3, 2, 0, 1) if path == _DW else a


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def _jax_unit(unit, gj, m):
    """The JAX unit as a function of (params, batch inputs) -> outputs,
    on the jnp twins, with the given masks."""
    f32 = jnp.float32

    def swa(p, x, bk, bv):
        xn = RJ.layer_norm(x, p["norm1"], f32)
        out, normed = RJ.swa_ref(p["swa"], xn, bk, bv, gj, f32,
                                 masks=(m["swa_attn"], m["swa_proj"]))
        return (out, xn), normed

    def msda(p, xn, bk, bv):
        out, normed = RJ.msda_ref(p["msda"], xn, bk, bv, gj, f32,
                                  masks=(m["msda_attn"], m["msda_proj"]))
        return (out,), normed

    def cga(p, xn, bk, bv):
        out, normed = RJ.cga_ref(p["cga"], xn, bk, bv, gj, f32,
                                 masks=(m["cga_attn"], m["cga_proj"]))
        return (out,), normed

    def cross_tail(p, x, xn, o, mo, co, bk, bv):
        cross = RJ.cross_ref(p["cross_attn"], xn, bk, bv, gj, f32,
                             masks=(m["cross_attn"], m["cross_proj"]))
        y = RJ.tail_ref(p, x, (o, mo, co, cross), gj, f32,
                        masks=(m["bn1"], m["bn2"], m["dp1"], m["ffn"],
                               m["dp2"]))
        return (y,), None

    return {"unit_swa": swa, "unit_msda": msda, "unit_cga": cga,
            "unit_cross_tail": cross_tail}[unit]


def _port_unit(unit, gt, mt, bankp):
    f32 = torch.float32

    def swa(p, x, bk, bv):
        xn = RT.layer_norm(x, p["norm1"], f32)
        out, normed = RT.swa_ref(p["swa"], xn, bk, bv, gt, f32,
                                 (mt["swa_attn"], mt["swa_proj"]))
        return (out, xn), RT.bank_write_partial(bankp, normed)

    def msda(p, xn, bk, bv):
        out, normed = RT.msda_ref(p["msda"], xn, bk, bv, gt, f32,
                                  (mt["msda_attn"], mt["msda_proj"]))
        return (out,), RT.bank_write_partial(bankp, normed)

    def cga(p, xn, bk, bv):
        out, normed = RT.cga_ref(p["cga"], xn, bk, bv, gt, f32,
                                 (mt["cga_attn"], mt["cga_proj"]))
        return (out,), RT.bank_write_partial(bankp, normed)

    def cross_tail(p, x, xn, o, mo, co, bk, bv):
        cross = RT.cross_ref(p["cross_attn"], xn, bk, bv, gt, f32,
                             (mt["cross_attn"], mt["cross_proj"]))
        y = RT.tail_ref(p, x, (o, mo, co, cross), gt, f32,
                        (mt["bn1"], mt["bn2"], mt["dp1"], mt["ffn"],
                         mt["dp2"]))
        return (y,), None

    return {"unit_swa": swa, "unit_msda": msda, "unit_cga": cga,
            "unit_cross_tail": cross_tail}[unit]


@pytest.mark.parametrize("masks", ["dropout0", "dropout_droppath"])
@pytest.mark.parametrize("unit", list(K.UNITS))
def test_train_unit_matches_jax(case, unit, masks):
    jcfg, gj, gt, pj, pt, bankp, bank, x, cots = case
    rate, dpr = (0.0, 0.0) if masks == "dropout0" else (0.1, 0.1)
    gj, mj, mt = _jax_masks(gj, rate, dpr)
    gt = gt._replace(dropout=rate)
    rs = np.random.RandomState(4)
    branch = [rs.standard_normal(x.shape).astype(np.float32)
              for _ in range(3)]
    batch = {"unit_swa": [x] + bank, "unit_msda": [x] + bank,
             "unit_cga": [x] + bank,
             "unit_cross_tail": [x, x * 0.5] + branch + bank}[unit]
    paths = [path for path, _ in K.unit_params(unit, pt)]
    n_out = K._N_DIFF_OUT[unit]

    # JAX: outputs, partials, vjp
    def fj(wts, *ins):
        p = jax.tree_util.tree_map(lambda a: a, pj)
        for path, w in zip(paths, wts):
            _set(p, _jpath(path), w)
        outs, normed = _jax_unit(unit, gj, mj)(p, *ins)
        return outs, normed

    wj = [jnp.asarray(_get(pj, _jpath(path))) for path in paths]
    insj = [jnp.asarray(a) for a in batch]
    (outs_j, normed_j), vjp = jax.vjp(fj, wj, *insj)
    grads_j = vjp((tuple(jnp.asarray(c) for c in cots[:n_out]),
                   jnp.zeros_like(normed_j) if normed_j is not None
                   else None))

    # port: outputs, partials, autograd
    wt = [torch.from_numpy(_to_port(path, _get(pj, _jpath(path))).copy()
                           ).requires_grad_() for path in paths]
    p = {k: v for k, v in pt.items()}
    p = jax.tree_util.tree_map(lambda a: a, p)
    for path, w in zip(paths, wt):
        _set(p, path, w)
    inst = [torch.from_numpy(a).requires_grad_() for a in batch]
    bp = {k: torch.from_numpy(np.asarray(v)) for k, v in bankp.items()}
    outs_t, parts_t = _port_unit(unit, gt, mt, bp)(p, *inst)
    grads_t = torch.autograd.grad(outs_t, wt + inst,
                                  [torch.from_numpy(c)
                                   for c in cots[:n_out]],
                                  allow_unused=True)
    for o_t, o_j in zip(outs_t, outs_j):
        _close(o_t, o_j, f"{unit} output")
    if normed_j is not None:
        pk, pv = RJ.bank_write_partial(bankp, normed_j)
        _close(parts_t[0], pk, "part_k")
        _close(parts_t[1], pv, "part_v")
    gj_flat = list(grads_j[0]) + list(grads_j[1:])
    paths_all = paths + [(f"input{i}",) for i in range(len(batch))]
    floor = 1e-2 * max(float(np.abs(np.asarray(g)).max()) for g in gj_flat)
    for path, g_t, g_j in zip(paths_all, grads_t, gj_flat):
        g_j = _to_port(path, g_j)
        g_t = torch.zeros(g_j.shape) if g_t is None else g_t
        _close(g_t, g_j, f"{unit} d {'/'.join(path)}", floor)


@pytest.mark.parametrize("which", ["tiny", "narrow_tin"])
def test_train_block_matches_jax_pallas_interpret(tiny_cfg, monkeypatch,
                                                  which):
    """One fused block in training at dropout 0 (three bank writes, each
    unit reading the bank its predecessor wrote): the port's units against
    the JAX package's Pallas units in interpret mode (fused_pallas
    fwd_call / bwd_call), output, bank state and gradients, at the tiny
    width (n=16) and at the narrow n=64 geometry in four SWA windows
    (interpret mode takes minutes at full width)."""
    import qavit_tpu.kernels.fused_block as FB
    from qavit_tpu.configs.model import BankConfig as JBankCfg
    from qavit_tpu.nn.bank import BankState as JState
    from qavit_tpu_torch.configs.model import BankConfig
    from qavit_tpu_torch.kernels.fused_block import fused_quad_block
    from qavit_tpu_torch.nn.bank import BankState

    jcfg, gj, gt, pj, pt, bankp, bank, x, cots = _make_case(which, tiny_cfg)
    gj, gt = gj._replace(dropout=0.0), gt._replace(dropout=0.0)
    monkeypatch.setattr(FB, "FORCE_PALLAS_INTERPRET", True)

    def fj(p, xx, bk, bv):
        y, st = FB.fused_quad_block(p, xx, JState(bk, bv, jnp.int32(5)), 0.0,
                                    bankp, JBankCfg(), gj, jnp.float32, True,
                                    jax.random.PRNGKey(0), None)
        return y, (st.k, st.v, st.count)

    yj, vjp, (kj, vj, cj) = jax.vjp(fj, pj, jnp.asarray(x),
                                    *map(jnp.asarray, bank), has_aux=True)
    dj = vjp(jnp.asarray(cots[0]))
    p = jax.tree_util.tree_map(lambda a: a, pt)
    wt = {path: torch.from_numpy(_to_port(path, _get(pj, _jpath(path)))
                                 .copy()).requires_grad_()
          for u in K.UNITS for path, _ in K.unit_params(u, pt)}
    for path, w in wt.items():
        _set(p, path, w)
    xt = torch.from_numpy(x).requires_grad_()
    bt = [torch.from_numpy(b).requires_grad_() for b in bank]
    bp = {k: torch.from_numpy(np.asarray(v)) for k, v in bankp.items()}
    yt, st = fused_quad_block(
        p, xt, BankState(bt[0], bt[1], torch.tensor(5, dtype=torch.int32)),
        gt, torch.float32, K.UnitTrain(RT.block_rng(0, 0.0, 0.0), bp),
        BankConfig())
    _close(yt, yj, "block output")
    _close(st.k, kj, "bank k")
    _close(st.v, vj, "bank v")
    assert int(st.count) == int(cj) == 8
    grads = torch.autograd.grad(yt, list(wt.values()) + [xt] + bt,
                                torch.from_numpy(cots[0]), allow_unused=True)
    ref = [_to_port(path, _get(dj[0], _jpath(path))) for path in wt] + [
        dj[1], dj[2], dj[3]]
    floor = 1e-2 * max(float(np.abs(np.asarray(r)).max()) for r in ref)
    names = ["/".join(path) for path in wt] + ["x", "bank_k", "bank_v"]
    for name, g_t, g_j in zip(names, grads, ref):
        g_t = torch.zeros(np.shape(g_j)) if g_t is None else g_t
        _close(g_t, g_j, f"block d {name}", floor)
