"""Depthwise convolutions as grouped ``nn.Conv2d``.

``qavit_tpu/nn/dwconv.py:63-101`` rewrote them as matmuls, an XLA-level
trick for the TPU and not a Pallas kernel; on the card the grouped
convolution is the plain operator.  Parameters: OIHW ``[C, 1, k, k]``,
the bridge transposes the flax ``[k, k, 1, C]`` kernel.
"""

from __future__ import annotations

import torch.nn as nn


def depthwise_conv2d(channels: int, kernel_size: int,
                     bias: bool = True) -> nn.Conv2d:
    """SAME-padded depthwise conv (odd kernel) over ``channels``."""
    return nn.Conv2d(channels, channels, kernel_size,
                     padding=kernel_size // 2, groups=channels, bias=bias)
