"""The four Quad-Attention branches
(counterpart of ``qavit_tpu/nn/branches.py``).

Each branch is its parameter holder from ``kernels/fused_params.py``
(the JAX tree's paths) with a forward
``branch(x, state, dtype, rng=None, write=None) -> (out, state)`` that
follows the flax module's arithmetic and rounding points.  In eval (no
``rng``) nothing writes to the bank (``qavit_tpu/nn/bank.py:110``), so
the state only supplies the bank rows the branches read.  In training
each attention drops probabilities at ``cfg.dropout`` (a counter-hash
mask salted by ``rng.salt()``), each proj output is dropped out from
``rng``'s generator, and SWA, MSDA and CGA then write their LayerNormed
output to the bank (with the bank's write projections ``write``), so
the next branch reads the updated rows.  Every attention
goes through :func:`guarded_attention`, hence through the dispatch of
``kernels/attention.py``: in eval at 224 the MSDA and cross attentions
(196 queries, head width 48) take the flash kernel on the card, SWA (49
queries per window) and CGA (head width 4) the plain path; in training
with dropout every attention takes the plain path, as in JAX.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from qavit_tpu_torch.configs.model import ModelConfig
from qavit_tpu_torch.kernels.attention import attention
from qavit_tpu_torch.kernels.fused_params import (BlockDims, CGAParams,
                                                  CrossParams, MSDAParams,
                                                  SWAParams)
from qavit_tpu_torch.kernels.fused_ref import (bank_write_partial, dense,
                                               layer_norm, merge_heads, mm,
                                               split_heads)
from qavit_tpu_torch.nn import taps
from qavit_tpu_torch.nn.bank import BankState, finish_bank_update
from qavit_tpu_torch.nn.layers import DropoutRng, dropout, param_tree


def guarded_attention(q, k, v, *, dropout: float, train: bool,
                      rng: Optional[int], impl: str,
                      guard: bool) -> torch.Tensor:
    """Attention with the whole-tensor NaN guard: if any input or the
    output holds a NaN, zeros (``branches.py:32-44``).  The guard is one
    ``where`` on the device, no host sync."""
    out = attention(q, k, v, dropout_rate=dropout, deterministic=not train,
                    rng=rng, impl=impl)
    if not guard:
        return out
    bad = (torch.isnan(q).any() | torch.isnan(k).any() | torch.isnan(v).any()
           | torch.isnan(out).any())
    return torch.where(bad, torch.zeros_like(out), out)


def linformer(p, k: torch.Tensor, v: torch.Tensor, seq_len: int,
              dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """LinformerCompression (``layers.py:98-117``): pad or truncate the
    token axis to ``seq_len``, then mix it with E_k / E_v cast to
    ``dtype``, products summed in float32 and rounded once."""
    n = k.shape[1]
    if n < seq_len:
        k = F.pad(k, (0, 0, 0, 0, 0, seq_len - n))
        v = F.pad(v, (0, 0, 0, 0, 0, seq_len - n))
    elif n > seq_len:
        k, v = k[:, :seq_len], v[:, :seq_len]

    def mix(e, t):
        return torch.einsum("nm,bnhd->bmhd", e.to(dtype).float(),
                            t.to(dtype).float()).to(dtype)

    return mix(p["E_k"], k), mix(p["E_v"], v)


def _bank_heads(state: BankState, batch: int, heads: int, dtype
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``bank_read`` split into heads: the bank rows in ``dtype``,
    broadcast to the batch (a stride-0 view)."""
    s, c = state.k.shape[1:]
    k = state.k.to(dtype).expand(batch, s, c)
    v = state.v.to(dtype).expand(batch, s, c)
    return k.reshape(batch, s, heads, c // heads), \
        v.reshape(batch, s, heads, c // heads)


def _attend(cfg: ModelConfig, q, k, v, rng: Optional[DropoutRng],
            impl: Optional[str] = None):
    train = rng is not None
    return guarded_attention(
        q, k, v, dropout=cfg.dropout, train=train,
        rng=rng.salt() if train and cfg.dropout > 0 else None,
        impl=impl or cfg.attn_impl, guard=cfg.guard_nans)


def _write(cfg: ModelConfig, p, out: torch.Tensor, state: BankState, dtype,
           write: Optional[dict]) -> BankState:
    """A writing branch's tail in training: its output LayerNormed
    (``norm``) and written to the bank (``qavit_tpu/nn/bank.py:101-140``);
    in eval (no ``write``) the state unchanged."""
    if write is None:
        return state
    pk, pv = bank_write_partial(write, layer_norm(out, p["norm"], dtype))
    return finish_bank_update(cfg.bank, state, pk, pv, out.shape[0])


class SpatialWindowAttention(SWAParams):
    """SWA: windowed attention with Linformer-compressed K/V plus the
    bank keys (``branches.py:57-127``); the grid is zero-padded to whole
    windows and cropped back."""

    def __init__(self, cfg: ModelConfig, dims: BlockDims):
        super().__init__(cfg.embed_dim, dims)
        self.cfg = cfg

    def forward(self, x: torch.Tensor, state: BankState, dtype,
                rng: Optional[DropoutRng] = None,
                write: Optional[dict] = None
                ) -> Tuple[torch.Tensor, BankState]:
        cfg, p = self.cfg, param_tree(self)
        b, n, c = x.shape
        h = w = math.isqrt(n)
        ws = cfg.window_size
        pad_h, pad_w = (ws - h % ws) % ws, (ws - w % ws) % ws
        hp, wp = h + pad_h, w + pad_w
        xw = x.reshape(b, h, w, c)
        if pad_h or pad_w:
            xw = F.pad(xw, (0, 0, 0, pad_w, 0, pad_h))
        nh, nw = hp // ws, wp // ws
        xw = xw.reshape(b, nh, ws, nw, ws, c).permute(0, 1, 3, 2, 4, 5)
        xw = xw.reshape(b * nh * nw, ws * ws, c)
        bw = xw.shape[0]

        qkv = dense(xw, p["qkv"], dtype)
        q, k, v = (split_heads(t, cfg.num_heads) for t in qkv.chunk(3, -1))
        k_c, v_c = linformer(p["linformer"], k, v, ws * ws, dtype)
        kb, vb = _bank_heads(state, bw, cfg.num_heads, dtype)
        k_full = torch.cat([k_c, kb], 1)
        taps.sow("swa.attn_q", q)            # attention rollout's taps
        taps.sow("swa.attn_k", k_full)
        out = _attend(cfg, q, k_full, torch.cat([v_c, vb], 1), rng)
        out = dropout(dense(merge_heads(out), p["proj"], dtype), cfg.dropout,
                      rng)
        out = out.reshape(b, nh, nw, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
        out = out.reshape(b, hp, wp, c)[:, :h, :w].reshape(b, n, c)
        return out, _write(cfg, p, out, state, dtype, write)


class MultiScaleDilatedAttention(MSDAParams):
    """MSDA: full-resolution queries against strided-dilation samples,
    average-pooled by the landmark stride, padded or truncated to
    ``msda_pad_len``, Linformer-compressed, plus the bank keys
    (``branches.py:130-202``)."""

    def __init__(self, cfg: ModelConfig, dims: BlockDims):
        super().__init__(cfg, dims)
        self.cfg = cfg

    def forward(self, x: torch.Tensor, state: BankState, dtype,
                rng: Optional[DropoutRng] = None,
                write: Optional[dict] = None
                ) -> Tuple[torch.Tensor, BankState]:
        cfg, p = self.cfg, param_tree(self)
        b, n, c = x.shape
        h = w = math.isqrt(n)
        kernel = self.qkv_kernel.to(dtype)
        bias = self.qkv_bias.to(dtype)

        grid = x.reshape(b, h, w, c)
        x_multi = torch.cat([grid[:, ::d, ::d].reshape(b, -1, c)
                             for d in cfg.dilation_factors], dim=1)
        s = cfg.landmark_pooling_stride
        m = x_multi.shape[1] // s
        # jnp.mean of a bf16 array sums in float32, rounds once
        pooled = x_multi[:, :m * s].reshape(b, m, s, c).float().mean(2).to(
            x.dtype)

        kv = mm(pooled.to(dtype), kernel[:, c:], dtype) + bias[c:]
        k, v = (split_heads(t, cfg.num_heads) for t in kv.chunk(2, -1))
        k_c, v_c = linformer(p["linformer"], k, v, cfg.msda_pad_len, dtype)
        kb, vb = _bank_heads(state, b, cfg.num_heads, dtype)
        q = split_heads(mm(x.to(dtype), kernel[:, :c], dtype) + bias[:c],
                        cfg.num_heads)
        out = _attend(cfg, q, torch.cat([k_c, kb], 1),
                      torch.cat([v_c, vb], 1), rng)
        out = dropout(dense(merge_heads(out), p["proj"], dtype), cfg.dropout,
                      rng)
        return out, _write(cfg, p, out, state, dtype, write)


class ChannelGroupAttention(CGAParams):
    """CGA: attention inside channel groups over their compressed
    projections and the bank projected to the group width, always on the
    plain path (head width 4; ``branches.py:205-276``)."""

    def __init__(self, cfg: ModelConfig, dims: BlockDims):
        super().__init__(cfg.embed_dim, dims)
        self.cfg = cfg

    def forward(self, x: torch.Tensor, state: BankState, dtype,
                rng: Optional[DropoutRng] = None,
                write: Optional[dict] = None
                ) -> Tuple[torch.Tensor, BankState]:
        cfg, p = self.cfg, param_tree(self)
        b, n, c = x.shape
        g = cfg.num_channel_groups
        cpg, comp_c = c // g, c // 2
        cperg, heads = comp_c // g, cfg.num_heads
        xg = x.reshape(b, n, g, cpg).permute(0, 2, 1, 3).reshape(b * g, n,
                                                                 cpg)
        q, k, v = (split_heads(dense(xg, p[f"{t}_proj"], dtype), heads)
                   for t in "qkv")
        s = state.k.shape[1]
        kb, vb = (dense(t.to(dtype), p[f"bank_{name}_proj"], dtype)
                  .expand(b * g, s, cperg)
                  for name, t in (("k", state.k), ("v", state.v)))
        out = _attend(cfg, q, torch.cat([k, split_heads(kb, heads)], 1),
                      torch.cat([v, split_heads(vb, heads)], 1), rng,
                      impl="xla")
        out = merge_heads(out).reshape(b, g, n, cperg).permute(
            0, 2, 1, 3).reshape(b, n, comp_c)
        out = dropout(dense(out, p["proj"], dtype), cfg.dropout, rng)
        return out, _write(cfg, p, out, state, dtype, write)


class CrossAttentionBranch(CrossParams):
    """Cross attention of the tokens onto the bank (``branches.py:
    279-315``): K and V are Dense of the bank rows, computed once and
    broadcast to the batch as a stride-0 view; it reads the bank and
    never writes it."""

    def __init__(self, cfg: ModelConfig, dims: BlockDims):
        super().__init__(cfg.embed_dim)
        self.cfg = cfg

    def forward(self, x: torch.Tensor, state: BankState, dtype,
                rng: Optional[DropoutRng] = None,
                write: Optional[dict] = None
                ) -> Tuple[torch.Tensor, BankState]:
        cfg, p = self.cfg, param_tree(self)
        b = x.shape[0]
        heads = cfg.num_heads
        q = split_heads(dense(x, p["q_proj"], dtype), heads)
        k, v = (split_heads(dense(t.to(dtype), p[f"{name}_proj"], dtype),
                            heads).expand(b, -1, -1, -1)
                for name, t in (("k", state.k), ("v", state.v)))
        out = _attend(cfg, q, k, v, rng)
        out = dropout(dense(merge_heads(out), p["proj"], dtype), cfg.dropout,
                      rng)
        return out, state
