"""``cli.train`` with the fused units' plain PyTorch versions in place of
their kernels: a control run that tells a kernel's fault from the
recipe's own training dynamics.

    python -m qavit_tpu_torch.cli.train_plain --preset hqavit_proc100_hard \
        --epochs 3 --warmup-epochs 2 --seed 43 [any cli.train argument]

Every ``fused_kernels.unit_*`` call goes to ``fused_kernels.PLAIN`` (the
versions each kernel is held against; autograd differentiates them), so
the run launches no unit kernel; everything else is ``cli.train``.  On
the card it is slower than the kernel path and rounds in another order,
so its trajectory is its own.
"""

from __future__ import annotations

import sys
from typing import List, Optional
from unittest import mock

from qavit_tpu_torch.cli import train
from qavit_tpu_torch.kernels import fused_kernels as K


def main(argv: Optional[List[str]] = None) -> float:
    with mock.patch.multiple(K, **K.PLAIN):
        return train.main(argv)


if __name__ == "__main__":
    main(sys.argv[1:])
