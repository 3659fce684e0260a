"""Train in two segments with a stop in between: a preemption drill for
``cli.train``'s checkpoints and ``--resume``.

    python -m qavit_tpu_torch.cli.train_segments --stop-after 10 -- \
        --preset hqavit_proc100_hard --epochs 16 --warmup-epochs 2 \
        --data-root DIR --checkpoint-dir CK --log-dir LOG

Runs ``python -u -m qavit_tpu_torch.cli.train ARGS`` and stops it (SIGTERM)
once ``CK/checkpoint_epoch_{N}/meta.json`` exists and epoch N is in
``LOG/training_metrics.json`` (N = ``--stop-after``, a multiple of the
preset's ``save_freq``), wherever the run then is: in epoch N+1's steps or
its evaluation.  Then it runs ``cli.train ARGS --resume
CK/checkpoint_epoch_{N}``, which continues at epoch N+1 and the same
history file.  Each segment's output goes to ``LOG/segment{1,2}.log``;
the seconds of each are printed.  Exits with the second segment's code.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import List, Optional

from qavit_tpu_torch.configs import get_preset


def _flag(args: List[str], name: str) -> str:
    if name not in args:
        raise SystemExit(f"train_segments needs {name} in the train args")
    return args[args.index(name) + 1]


def _logged(log_dir: Path, epoch: int) -> bool:
    try:
        d = json.loads((log_dir / "training_metrics.json").read_text())
    except (OSError, ValueError):
        return False
    return epoch in d["history"]["epoch"]


def _run(args: List[str], log: Path, stop=None) -> int:
    cmd = [sys.executable, "-u", "-m", "qavit_tpu_torch.cli.train"] + args
    with open(log, "w") as out:
        proc = subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT)
        while proc.poll() is None:
            if stop is not None and stop():
                proc.terminate()
                break
            time.sleep(1.0)
        return proc.wait()


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--stop-after", type=int, default=10,
                   help="the epoch whose periodic checkpoint resumes")
    p.add_argument("train_args", nargs=argparse.REMAINDER,
                   help="-- then cli.train's arguments")
    args = p.parse_args(argv)
    train_args = [a for a in args.train_args if a != "--"]
    save_freq = get_preset(_flag(train_args, "--preset")).train.save_freq
    if args.stop_after % save_freq:
        raise SystemExit(f"--stop-after {args.stop_after}: the preset saves "
                         f"a checkpoint every {save_freq} epochs")
    ck = Path(_flag(train_args, "--checkpoint-dir"))
    log = Path(_flag(train_args, "--log-dir"))
    log.mkdir(parents=True, exist_ok=True)
    saved = ck / f"checkpoint_epoch_{args.stop_after}"

    def stop() -> bool:
        return (saved / "meta.json").exists() and _logged(log,
                                                          args.stop_after)

    t0 = time.time()
    rc = _run(train_args, log / "segment1.log", stop)
    t1 = time.time()
    print(f"segment 1: rc {rc}, {t1 - t0:.1f} s, stopped after epoch "
          f"{args.stop_after}: {stop()}", flush=True)
    if not stop():
        return rc or 1
    rc = _run(train_args + ["--resume", str(saved)], log / "segment2.log")
    print(f"segment 2 (--resume {saved}): rc {rc}, "
          f"{time.time() - t1:.1f} s", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
