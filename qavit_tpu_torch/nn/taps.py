"""Interpretability taps: the port's counterpart of flax's
``self.sow("intermediates", ...)`` (``qavit_tpu/nn/block.py:137``,
``nn/branches.py:104-109``).

A forward run inside :func:`record` collects, in call order, the tensors
the modules hand to :func:`sow`: TokenLearner's softmax weights ``[B, N,
M]`` (``"token_learner.weights"``, one entry a block) and the SWA
branch's queries and keys ``[B * nW, ws2, H, D]`` / ``[B * nW, lin_k + S,
H, D]`` (``"swa.attn_q"``, ``"swa.attn_k"``, one entry a block of the
branch path).  Outside :func:`record` a tap is one ``None`` check: a
forward that records nothing runs as before.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Optional

import torch

_RECORD: Optional[Dict[str, List[torch.Tensor]]] = None


@contextlib.contextmanager
def record() -> Iterator[Dict[str, List[torch.Tensor]]]:
    """Collect every tap of the forwards run inside: {name: [tensor, one
    a call, in call order]}, detached."""
    global _RECORD
    outer, _RECORD = _RECORD, {}
    try:
        yield _RECORD
    finally:
        _RECORD = outer


def sow(name: str, value: torch.Tensor) -> None:
    if _RECORD is not None:
        _RECORD.setdefault(name, []).append(value.detach())
