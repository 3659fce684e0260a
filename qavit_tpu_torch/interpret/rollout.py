"""Attention rollout for the QA-ViT family (counterpart of
``qavit_tpu/interpret/rollout.py``).

No branch of QA-ViT forms a positional NxN attention map: every key set
is Linformer-compressed, landmark-pooled or a learned bank.  Two
positional maps can be recovered:

* **Hybrid models with a TokenLearner**: the TokenLearner / TokenUpMix
  pair around every block mixes tokens positionally, so the block's
  mixing matrix is T = rownorm(|upmix|^T) @ rownorm(W^T), W the learner's
  softmax weights (recorded by ``nn/taps.py``).  The fused units stay on
  this path: the map lies outside them.
* **The flat QAViT**: the SWA branch attends window queries to
  Linformer-compressed window keys, k_c[m] = sum_j E_k[j, m] k[j], so the
  mass on compressed slot m goes back onto positions by R[m, j] =
  |E_k[j, m]| / sum_j |E_k[j, m]|.  Per block M = A[:, :lin_k] @ R, window
  by window (bank-key mass dropped, rows renormalised); q and k come from
  the SWA branch's taps, so a model built with ``attn_impl="fused_block"``
  is evaluated on the branch path with the same weights.  A single-branch
  approximation, not a rollout of the whole four-branch block.

Rollout composes 0.5 T + 0.5 I across blocks (Abnar & Zuidema's residual
correction) and mean-pools the query side (the models classify by mean
pooling, not a CLS token).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from qavit_tpu_torch.interpret.gradcam import _device, _image, upsample_map
from qavit_tpu_torch.nn import taps
from qavit_tpu_torch.nn.models import QAViT


def _normalize_rows(m):
    return m / (m.sum(-1, keepdims=True) + 1e-8)


def _finish(rollout: torch.Tensor, n: int, hw) -> np.ndarray:
    return upsample_map(rollout.float().mean(dim=0), n, hw)


def _record(model, x: torch.Tensor, bank_count) -> dict:
    with torch.inference_mode(), taps.record() as rec:
        model(x, bank_count=bank_count)
    return rec


def _window_positions(grid: int, ws: int):
    """The SWA window partition (``nn/branches.py``) as one permutation:
    the padded-grid position of every (window, local) pair, and the
    padded position of each real token."""
    pad_grid = grid + (ws - grid % ws) % ws
    nw_side = pad_grid // ws
    wr, wc = np.divmod(np.arange(nw_side * nw_side), nw_side)
    lr, lc = np.divmod(np.arange(ws * ws), ws)
    row = wr[:, None] * ws + lr[None, :]             # [nW, ws2] padded row
    col = wc[:, None] * ws + lc[None, :]             # [nW, ws2] padded col
    pad_pos = row * pad_grid + col
    valid = (row < grid) & (col < grid)
    pad_of_tok = np.empty(grid * grid, np.int64)
    pad_of_tok[(row * grid + col)[valid]] = pad_pos[valid]
    return pad_grid, pad_pos, pad_of_tok


def _swa_rollout(model, image, bank_count) -> np.ndarray:
    """SWA-branch rollout of the flat QAViT (module docstring)."""
    cfg = model.cfg
    dev = _device(model)
    if cfg.attn_impl == "fused_block":
        # the fused units never form q and k: the branch path, same weights
        branch = QAViT(cfg.replace(attn_impl="auto")).to(dev)
        branch.load_state_dict(model.state_dict())
        model = branch.eval()
    x = _image(image, dev)[None]
    rec = _record(model, x, bank_count)
    q_all = torch.stack(rec["swa.attn_q"]).float()   # [depth, nW, ws2, H, D]
    k_all = torch.stack(rec["swa.attn_k"]).float()   # [depth, nW, K, H, D]
    e_k = torch.stack([blk.swa.linformer.E_k.detach()
                       for blk in model.blocks]).float()   # [depth, ws2, lk]

    n, lin_k = cfg.num_patches, cfg.linformer_k
    pad_grid, pad_pos, pad_of_tok = _window_positions(math.isqrt(n),
                                                      cfg.window_size)
    with torch.no_grad():
        logits = torch.einsum("bwnhd,bwmhd->bwhnm", q_all, k_all) \
            / math.sqrt(q_all.shape[-1])
        attn = torch.softmax(logits, dim=-1).mean(2)
        r_map = e_k.abs()
        r_map = r_map / (r_map.sum(1, keepdim=True) + 1e-8)
        m_win = torch.einsum("bwnk,bjk->bwnj", attn[..., :lin_k], r_map)
        m_win = _normalize_rows(m_win).cpu().numpy()  # [depth, nW, ws2, ws2]

    # one batched scatter into padded block-diagonal maps, then the real
    # tokens' rows and columns, renormalised over the surviving columns
    depth, p_tot = m_win.shape[0], pad_grid * pad_grid
    t_pad = np.zeros((depth, p_tot, p_tot), np.float32)
    t_pad[:, pad_pos[:, :, None], pad_pos[:, None, :]] = m_win
    t = t_pad[:, pad_of_tok[:, None], pad_of_tok[None, :]]
    t = t / (t.sum(-1, keepdims=True) + 1e-8)        # [depth, n, n]
    rollout = np.eye(n, dtype=np.float32)
    eye = np.eye(n, dtype=np.float32)
    for b in range(depth):
        rollout = (0.5 * t[b] + 0.5 * eye) @ rollout
    return _finish(torch.from_numpy(rollout), n, tuple(x.shape[1:3]))


def attention_rollout(model, image, bank_count=0) -> np.ndarray:
    """Rollout saliency [H, W] in [0, 1] for one image.

    Hybrid models with a TokenLearner use the learner / upmix positional
    map; the flat QAViT the SWA Linformer back-mapped attention.  Hybrid
    models without a TokenLearner have no positional mixing map: raises
    (use grad_cam there)."""
    cfg = model.cfg
    if not cfg.hybrid:
        return _swa_rollout(model, image, bank_count)
    if not cfg.use_token_learner:
        raise ValueError("attention rollout on hybrid models requires the "
                         "TokenLearner wrapper; use grad_cam instead")
    dev = _device(model)
    x = _image(image, dev)[None]
    weights = iter(_record(model, x, bank_count)["token_learner.weights"])
    n = cfg.num_patches
    eye = torch.eye(n, device=dev)
    rollout = eye
    with torch.no_grad():
        for stage_idx in model.stages:
            for block in getattr(model, f"stage{stage_idx}_blocks"):
                learner = next(weights)[0]                   # [N, M]
                upmix = block.token_upmix.upsample_attn.kernel.abs()
                t = _normalize_rows(upmix.T) @ _normalize_rows(learner.T)
                rollout = (0.5 * t + 0.5 * eye) @ rollout
    return _finish(rollout, n, tuple(x.shape[1:3]))
