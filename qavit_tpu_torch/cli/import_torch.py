"""Convert a reference PyTorch checkpoint (.pth) into a port checkpoint
(counterpart of ``qavit_tpu/cli/import_torch.py``).

    python -m qavit_tpu_torch.cli.import_torch --preset hqavit_c100 \\
        --torch-checkpoint best_model_ema.pth --out ./checkpoints/imported

Takes the reference's nested dicts ({'model_state_dict': ...} or
{'ema_state_dict': ...}, test_hqa.py:82-104), strips ``module.`` /
``_orig_mod.`` and maps every tensor through ``ckpt/torch_import.py``.
The result is a port checkpoint (``ckpt/checkpoint.py``) that
``cli.evaluate --checkpoint`` and ``cli.train --resume`` / ``--init-from``
read; the optimizer state starts fresh.  Runs on the CPU.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from qavit_tpu_torch.ckpt.checkpoint import save_train_state
from qavit_tpu_torch.ckpt.torch_import import load_torch_state_dict
from qavit_tpu_torch.configs import get_preset
from qavit_tpu_torch.nn.models import build_model
from qavit_tpu_torch.train.state import create_train_state


def main(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--preset", required=True)
    p.add_argument("--torch-checkpoint", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--state-key", default=None,
                   help="key of the state dict inside the .pth "
                        "(default: model_state_dict / ema_state_dict / "
                        "state_dict / the file itself)")
    args = p.parse_args(argv)

    ckpt = torch.load(args.torch_checkpoint, map_location="cpu",
                      weights_only=False)
    if args.state_key:
        sd = ckpt[args.state_key]
    else:
        sd = next((ckpt[k] for k in ("model_state_dict", "ema_state_dict",
                                     "state_dict")
                   if isinstance(ckpt, dict) and k in ckpt), ckpt)
    print(f"loaded {len(sd)} tensors from {args.torch_checkpoint}")

    preset = get_preset(args.preset)
    model = load_torch_state_dict(build_model(preset.model, "cpu"), sd)
    state = create_train_state(model, preset.train.use_ema,
                               preset.train.ema_decay)
    save_train_state(args.out, state, preset.model, preset.train,
                     {"imported_from": args.torch_checkpoint})
    print(f"wrote a port checkpoint to {args.out}")
    return state


if __name__ == "__main__":
    main()
