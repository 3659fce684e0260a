"""Plain PyTorch versions of the fused QuadAttentionBlock units (eval).

Counterpart of ``qavit_tpu/kernels/fused_ref.py``: pure functions over
explicit parameter dictionaries shaped like the JAX package's trees.
They are

* the CPU path of :mod:`qavit_tpu_torch.kernels.fused_kernels`, and
* the numerics reference the CUDA kernels are held against on the card.

Numerics follow the JAX twins: statistics in float32, every Dense output
rounded to the working dtype, products accumulated in float32
(``mm``), softmax in float32 with probabilities cast to v's dtype.
Only the eval forward lives here; dropout masks and bank writes come
with the training slice.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from qavit_tpu_torch.configs.model import ModelConfig

LN_EPS = 1e-5
Params = Dict[str, Any]


class FusedGeom(NamedTuple):
    """Static geometry of one fused block (derived from ModelConfig)."""

    n: int                 # tokens inside the block
    c: int                 # embed dim
    ws2: int               # tokens per SWA window (window_size**2)
    nw: int                # SWA windows per sample (1 = single-window)
    heads: int
    d: int                 # head dim
    lin_k: int             # linformer compressed length
    msda_keep: int         # pooled MSDA token count (pre-pad, <= pad_len)
    msda_idx: Tuple[int, ...]   # flat multi-scale gather indices
    pool_stride: int       # landmark pooling stride
    groups: int            # CGA channel groups
    cperg: int             # CGA compressed channels per group
    bank_s: int            # bank slots
    n_full: int            # tokens OUTSIDE the token learner (num_patches)
    m_learned: int         # learned tokens (== n when token learner on)
    ccf_hidden: int
    bottleneck_hidden: int
    d_c: int               # per-branch compressed dim (c // compress_ratio)
    dropout: float
    stabilized_ccfffn: bool
    stabilized_dwconv: bool
    dwconv_bias: bool
    guard_nans: bool
    use_token_learner: bool


def make_geom(cfg: ModelConfig) -> Optional[FusedGeom]:
    """Geometry if the fused path supports this config, else None
    (``qavit_tpu/kernels/fused_ref.py:60-106``)."""
    if cfg.use_token_learner:
        m = cfg.num_learned_tokens
        sq = math.isqrt(m)
        if sq * sq != m:
            m = max(4, sq * sq)
        n = m
    else:
        n = cfg.num_patches
    grid = math.isqrt(n)
    if grid * grid != n:
        return None
    ws = cfg.window_size
    if grid % ws != 0:
        return None
    nw = (grid // ws) ** 2
    idx = []
    for dil in cfg.dilation_factors:
        idx.extend(r * grid + col for r in range(0, grid, dil)
                   for col in range(0, grid, dil))
    s = cfg.landmark_pooling_stride
    keep = (len(idx) // s) * s
    pooled = min(keep // s, cfg.msda_pad_len)
    comp_c = cfg.embed_dim // 2
    return FusedGeom(
        n=n, c=cfg.embed_dim, ws2=ws * ws, nw=nw,
        heads=cfg.num_heads, d=cfg.head_dim,
        lin_k=cfg.linformer_k, msda_keep=pooled,
        msda_idx=tuple(idx[:keep]), pool_stride=s,
        groups=cfg.num_channel_groups,
        cperg=comp_c // cfg.num_channel_groups,
        bank_s=cfg.bank.size, n_full=cfg.num_patches, m_learned=n,
        ccf_hidden=int(cfg.embed_dim * cfg.mlp_ratio),
        bottleneck_hidden=cfg.embed_dim // cfg.bottleneck_ratio,
        d_c=cfg.embed_dim // cfg.compress_ratio,
        dropout=cfg.dropout,
        stabilized_ccfffn=cfg.stabilized_ccfffn,
        stabilized_dwconv=cfg.stabilized_dwconv,
        dwconv_bias=cfg.dwconv_bias,
        guard_nans=cfg.guard_nans,
        use_token_learner=cfg.use_token_learner,
    )


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def layer_norm(x: torch.Tensor, p: Params, dtype: torch.dtype,
               eps: float = LN_EPS) -> torch.Tensor:
    """flax ``nn.LayerNorm``: float32 statistics with the fast variance
    ``E[x^2] - mu^2`` clamped at 0."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf * xf).mean(-1, keepdim=True) - mu * mu).clamp_min(0.0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(dtype)


def mm(a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """a @ b from working-dtype operands with float32 accumulation and
    one rounding of the result to ``dtype``."""
    return torch.matmul(a.float(), b.float()).to(dtype)


def dense(x: torch.Tensor, p: Params, dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Dense`` with kernel ``[in, out]``."""
    y = mm(x.to(dtype), p["kernel"].to(dtype), dtype)
    return y + p["bias"].to(dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU in float32, rounded back to x's dtype."""
    return F.gelu(x.float()).to(x.dtype)


def attention_core(q, k, v, *, guard: bool) -> torch.Tensor:
    """Softmax attention on ``[B, N, H, D]`` tensors with the batch-wide
    NaN guard: when q, k, v or the output holds a NaN anywhere in the
    batch, the whole output is zero (``fused_ref.py:238-252``)."""
    d = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / (d ** 0.5)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(),
                       v.float()).to(q.dtype)
    if not guard:
        return out
    bad = (torch.isnan(q).any() | torch.isnan(k).any() | torch.isnan(v).any()
           | torch.isnan(out).any())
    return torch.where(bad, torch.zeros_like(out), out)


def split_heads(x: torch.Tensor, h: int) -> torch.Tensor:
    b, n, c = x.shape
    return x.reshape(b, n, h, c // h)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, n, h, d = x.shape
    return x.reshape(b, n, h * d)


def _token_mix(e: torch.Tensor, t: torch.Tensor, dtype) -> torch.Tensor:
    """einsum("nm,bnhd->bmhd") in float32, rounded to ``dtype``."""
    return torch.einsum("nm,bnhd->bmhd", e.to(dtype).float(),
                        t.float()).to(dtype)


def _with_bank(t_c, bank, g: FusedGeom, dtype):
    """Concatenate the raw bank rows ``[1, S, C]`` after the compressed
    tokens, per head."""
    kb = bank.expand(t_c.shape[0], -1, -1).to(dtype)
    return torch.cat([t_c, split_heads(kb, g.heads)], dim=1)


# ---------------------------------------------------------------------------
# unit functions
# ---------------------------------------------------------------------------

def window_partition(x: torch.Tensor, g: FusedGeom) -> torch.Tensor:
    """[B, N, C] -> [B*nw, ws2, C], window-major (no-op when nw == 1)."""
    if g.nw == 1:
        return x
    b, n, c = x.shape
    grid, ws = math.isqrt(n), math.isqrt(g.ws2)
    nh = grid // ws
    xw = x.reshape(b, nh, ws, nh, ws, c).permute(0, 1, 3, 2, 4, 5)
    return xw.reshape(b * g.nw, g.ws2, c)


def window_reverse(xw: torch.Tensor, g: FusedGeom, b: int) -> torch.Tensor:
    """[B*nw, ws2, C] -> [B, N, C] (inverse of window_partition)."""
    if g.nw == 1:
        return xw
    c = xw.shape[-1]
    grid, ws = math.isqrt(g.n), math.isqrt(g.ws2)
    nh = grid // ws
    x = xw.reshape(b, nh, nh, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, g.n, c)


def swa_ref(p: Params, xn, bank_k, bank_v, g: FusedGeom, dtype):
    """SWA branch: per-window Linformer-compressed K/V plus the bank rows
    (``fused_ref.py:336``).  bank_k/bank_v: ``[1, S, C]`` float32.
    Returns (out, normed)."""
    b = xn.shape[0]
    xw = window_partition(xn, g)
    qkv = dense(xw, p["qkv"], dtype)
    q, k, v = (split_heads(t, g.heads) for t in qkv.chunk(3, dim=-1))
    k_c = _token_mix(p["linformer"]["E_k"], k, dtype)
    v_c = _token_mix(p["linformer"]["E_v"], v, dtype)
    out = attention_core(q, _with_bank(k_c, bank_k, g, dtype),
                         _with_bank(v_c, bank_v, g, dtype),
                         guard=g.guard_nans)
    out = dense(merge_heads(out), p["proj"], dtype)
    out = window_reverse(out, g, b)
    return out, layer_norm(out, p["norm"], dtype)


def msda_mix_matrix(g: FusedGeom) -> np.ndarray:
    """Dilated gather + landmark average pooling as one constant
    ``[msda_keep, n]`` token-mixing matrix (``fused_ref.py:368-379``)."""
    m = np.zeros((g.msda_keep, g.n), np.float32)
    s = g.pool_stride
    for i in range(g.msda_keep):
        for j in range(s):
            m[i, g.msda_idx[i * s + j]] += 1.0 / s
    return m


def msda_ref(p: Params, xn, bank_k, bank_v, g: FusedGeom, dtype):
    """MSDA branch (``fused_ref.py:382-417``): pooled K/V through the
    first ``msda_keep`` rows of the padded Linformer E."""
    c = g.c
    kernel = p["qkv_kernel"].to(dtype)
    bias = p["qkv_bias"].to(dtype)
    sel = torch.from_numpy(msda_mix_matrix(g)).to(xn.device)
    pooled = torch.einsum("pn,bnc->bpc", sel.to(dtype).float(),
                          xn.to(dtype).float()).to(dtype)
    kv = mm(pooled, kernel[:, c:], dtype) + bias[c:]
    k, v = (split_heads(t, g.heads) for t in kv.chunk(2, dim=-1))
    k_c = _token_mix(p["linformer"]["E_k"][: g.msda_keep], k, dtype)
    v_c = _token_mix(p["linformer"]["E_v"][: g.msda_keep], v, dtype)
    q = split_heads(mm(xn.to(dtype), kernel[:, :c], dtype) + bias[:c],
                    g.heads)
    out = attention_core(q, _with_bank(k_c, bank_k, g, dtype),
                         _with_bank(v_c, bank_v, g, dtype),
                         guard=g.guard_nans)
    out = dense(merge_heads(out), p["proj"], dtype)
    return out, layer_norm(out, p["norm"], dtype)


def cga_ref(p: Params, xn, bank_k, bank_v, g: FusedGeom, dtype):
    """CGA branch (``fused_ref.py:420-448``): channel groups attend over
    their own tokens plus the bank projected to the group width."""
    b, n, c = xn.shape
    gg, cpg, cperg = g.groups, g.c // g.groups, g.cperg
    xg = xn.reshape(b, n, gg, cpg).permute(0, 2, 1, 3).reshape(b * gg, n, cpg)
    q = split_heads(dense(xg, p["q_proj"], dtype), g.heads)
    k = split_heads(dense(xg, p["k_proj"], dtype), g.heads)
    v = split_heads(dense(xg, p["v_proj"], dtype), g.heads)
    kbp = dense(bank_k.to(dtype), p["bank_k_proj"], dtype)   # [1, S, cperg]
    vbp = dense(bank_v.to(dtype), p["bank_v_proj"], dtype)
    s = kbp.shape[1]
    kbp = kbp.expand(b * gg, s, cperg)
    vbp = vbp.expand(b * gg, s, cperg)
    k_full = torch.cat([k, split_heads(kbp, g.heads)], dim=1)
    v_full = torch.cat([v, split_heads(vbp, g.heads)], dim=1)
    out = attention_core(q, k_full, v_full, guard=g.guard_nans)
    out = merge_heads(out).reshape(b, gg, n, cperg).permute(
        0, 2, 1, 3).reshape(b, n, gg * cperg)
    out = dense(out, p["proj"], dtype)
    return out, layer_norm(out, p["norm"], dtype)


def cross_ref(p: Params, xn, bank_k, bank_v, g: FusedGeom, dtype):
    """Cross-attention of the tokens onto the bank (``fused_ref.py:451``)."""
    q = split_heads(dense(xn, p["q_proj"], dtype), g.heads)
    k = split_heads(dense(bank_k.to(dtype), p["k_proj"], dtype), g.heads)
    v = split_heads(dense(bank_v.to(dtype), p["v_proj"], dtype), g.heads)
    b = xn.shape[0]
    out = attention_core(q, k.expand(b, -1, -1, -1), v.expand(b, -1, -1, -1),
                         guard=g.guard_nans)
    return dense(merge_heads(out), p["proj"], dtype)


def dwconv3x3_ref(x, weight, hw: Tuple[int, int], dtype):
    """Depthwise 3x3 correlation with a zero halo over a ``[B, N, C]``
    token grid, as 9 shifted float32 FMAs rounded once
    (``fused_ref.py:467-493``).  weight: ``[C, 1, 3, 3]`` (Conv2d)."""
    b, n, c = x.shape
    h, w = hw
    y = F.pad(x.reshape(b, h, w, c).float(), (0, 0, 1, 1, 1, 1))
    k = weight.reshape(c, 3, 3).float()
    out = torch.zeros(b, h, w, c, dtype=torch.float32, device=x.device)
    for ki in range(3):
        for kj in range(3):
            out = out + y[:, ki:ki + h, kj:kj + w, :] * k[:, ki, kj]
    return out.reshape(b, n, c).to(dtype)


def tail_ref(p: Params, xc, outs, g: FusedGeom, dtype):
    """Per-branch LN + compress -> softmax fusion -> bottleneck MLP ->
    residual -> norm2 -> CCF-FFN -> residual (``fused_ref.py:496-537``,
    eval: no dropout, drop-path is the identity)."""
    compressed = []
    for name, out in zip(("swa", "msda", "cga", "cross"), outs):
        o = layer_norm(out, p[f"norm_{name}"], dtype)
        compressed.append(dense(o, p[f"compress_{name}"], dtype))
    w = torch.softmax(p["fusion"]["fusion_weights"].float(), dim=0)
    fused = torch.cat([(o.float() * w[i]).to(o.dtype)
                       for i, o in enumerate(compressed)], dim=-1)
    y = gelu(dense(fused, p["bottleneck_mlp"]["fc1"], dtype))
    y = dense(y, p["bottleneck_mlp"]["fc2"], dtype)
    x = xc + y

    f = p["ccf_ffn"]
    hw = math.isqrt(g.n)
    y = gelu(dense(layer_norm(x, p["norm2"], dtype), f["fc1"], dtype))
    if g.stabilized_ccfffn:
        y = layer_norm(y, f["dwconv_norm"], dtype)
    dw = f["dwconv"]
    y = dwconv3x3_ref(y, dw["dwconv"]["weight"], (hw, hw), dtype)
    if "bias" in dw["dwconv"]:          # conv bias precedes the 0.1 scale
        y = y + dw["dwconv"]["bias"].to(y.dtype)
    if g.stabilized_dwconv:
        y = y * dw["scale"].to(y.dtype)
    if g.stabilized_ccfffn:
        y = layer_norm(y, f["post_dwconv_norm"], dtype)
    y = dense(y, f["fc2"], dtype)
    if g.stabilized_ccfffn:
        y = (y.float() * f["gamma"].float()).to(y.dtype)
    return x + y
