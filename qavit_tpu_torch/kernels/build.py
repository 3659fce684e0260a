"""Build and load the port's CUDA kernels (the counterpart of
``fused_pallas.py``'s runner role).

All of ``qavit_tpu_torch/csrc/*.cu`` is compiled by ONE ``nvcc`` call into
a shared library with a plain C interface, loaded with ``ctypes``.  No
PyTorch header is included, so the build takes seconds, not minutes.
The library is cached in ``qavit_tpu_torch/_build/`` (gitignored) under
a hash of the sources and flags, and built at first use, never at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas=-v")


@dataclass
class KernelLib:
    lib: ctypes.CDLL
    path: Path
    cache_hit: bool
    build_seconds: float
    log: str          # nvcc's output (ptxas register / spill report)


_LOADED: dict = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        exe = Path(cand) / "bin" / "nvcc"
        if cand and exe.exists():
            return str(exe)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def load(build_dir: Optional[Path] = None) -> KernelLib:
    """Build (if needed) and load the kernel library."""
    build_dir = Path(build_dir or BUILD_DIR)
    key = str(build_dir)
    if key in _LOADED:
        return _LOADED[key]
    sources = sorted(CSRC.glob("*.cu"))
    headers = sorted(CSRC.glob("*.cuh"))
    so = build_dir / f"libqavit_kernels_{_digest(sources + headers)}.so"
    log_path = so.with_suffix(".log")
    t0 = time.perf_counter()
    hit = so.exists()
    if not hit:
        build_dir.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        log_path.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    out = KernelLib(lib, so, hit, time.perf_counter() - t0,
                    log_path.read_text() if log_path.exists() else "")
    _LOADED[key] = out
    return out
