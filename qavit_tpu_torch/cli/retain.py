"""Export a slim copy of a training checkpoint of the port.

    python -m qavit_tpu_torch.cli.retain checkpoints/<run>/best_model <name>

writes ``checkpoints_keep/<name>``: the weights only ({params,
batch_stats, ema_params, ema_batch_stats, bank_count}), about half the
size of the full state, with no optimizer state or step
(``qavit_tpu_torch.ckpt.checkpoint.retain_checkpoint``).  The copy seeds
an evaluation, a finetune or a transfer, not a ``--resume``.
"""

from __future__ import annotations

import argparse
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> str:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("src", help="full checkpoint dir (holds state.pt)")
    p.add_argument("name", help="destination name under checkpoints_keep/")
    args = p.parse_args(argv)

    from qavit_tpu_torch.ckpt.checkpoint import retain_checkpoint

    dst = f"checkpoints_keep/{args.name}"
    retain_checkpoint(args.src, dst)
    print(f"retained {args.src} -> {dst}")
    return dst


if __name__ == "__main__":
    main()
