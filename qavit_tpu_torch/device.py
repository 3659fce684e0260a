"""Where the port runs: the card unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(name: str = "cuda") -> torch.device:
    """``torch.device(name)``; a CUDA device without CUDA raises (the port
    never falls back to the CPU on its own)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    return dev
