"""Build and load the port's CUDA kernels (the counterpart of
``fused_pallas.py``'s runner role).

Each of ``qavit_tpu_torch/csrc/*.cu`` is compiled by its own ``nvcc``
process, all started together, and one more ``nvcc`` links the objects
into a shared library with a plain C interface, loaded with ``ctypes``.
No PyTorch header is included, so the build takes seconds, not minutes.
The library is cached in ``qavit_tpu_torch/_build/`` (gitignored) under
a hash of the sources and flags, and built at first use, never at import.

    python -m qavit_tpu_torch.kernels.build [ROUNDS]

times a build from nothing this way against one nvcc call over all the
sources (:func:`compare_builds`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas=-v")


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


def _digest(sources, flags) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: List[List[str]]) -> List[subprocess.CompletedProcess]:
    """Run the commands in parallel; each one's output and return code."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = []
    for c, p in zip(cmds, procs):
        out, _ = p.communicate()
        outs.append(subprocess.CompletedProcess(c, p.returncode, out, ""))
    return outs


def _compile(sources, build_dir: Path, so: Path, flags=NVCC_FLAGS) -> str:
    """One nvcc per source, all at once, then one link; returns the log."""
    nvcc = _nvcc()
    tmp = Path(tempfile.mkdtemp(dir=build_dir))
    try:
        objs = [tmp / (src.stem + ".o") for src in sources]
        log = []
        for res in _run_all([[nvcc, *flags, "-c", str(src), "-o",
                              str(obj)] for src, obj in zip(sources, objs)]):
            log.append(res.stdout)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                                   f"{' '.join(res.args)}\n{res.stdout}")
        lib = tmp / "lib.so"
        link = [nvcc, "-shared", *NVCC_FLAGS[:2], "-o", str(lib),
                *map(str, objs)]
        res = _run_all([link])[0]
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{' '.join(link)}\n{res.stdout}")
        os.replace(lib, so)
        return "".join(log) + res.stdout
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def load(build_dir: Optional[Path] = None, defines=()) -> KernelLib:
    """Build (if needed) and load the kernel library; ``defines`` are
    extra ``-D`` flags (a timing build's, in a build directory of its
    own)."""
    build_dir = Path(build_dir or BUILD_DIR)
    flags = NVCC_FLAGS + tuple(defines)
    key = str(build_dir) + " ".join(defines)
    if key in _LOADED:
        return _LOADED[key]
    sources = sorted(CSRC.glob("*.cu"))
    headers = sorted(CSRC.glob("*.cuh"))
    digest = _digest(sources + headers, flags)
    so = build_dir / f"libqavit_kernels_{digest}.so"
    log_path = so.with_suffix(".log")
    t0 = time.perf_counter()
    hit = so.exists()
    if not hit:
        build_dir.mkdir(parents=True, exist_ok=True)
        log_path.write_text(_compile(sources, build_dir, so, flags))
    lib = ctypes.CDLL(str(so))
    out = KernelLib(lib, so, hit, time.perf_counter() - t0,
                    log_path.read_text() if log_path.exists() else "")
    _LOADED[key] = out
    return out


def _compile_single(sources, build_dir: Path, so: Path) -> str:
    """The alternative to :func:`_compile`: one nvcc call over every
    source, which compiles them one after another."""
    res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(so),
                          *map(str, sources)], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stdout}"
                           f"{res.stderr}")
    return res.stdout + res.stderr


def compare_builds(rounds: int = 2) -> None:
    """Time a build from nothing both ways, in turns (single, parallel,
    parallel, single, ...), each into a fresh directory, and print the
    seconds of each."""
    sources = sorted(CSRC.glob("*.cu"))
    order = [("single", _compile_single), ("parallel", _compile)]
    for r in range(rounds):
        for name, fn in (order if r % 2 == 0 else order[::-1]):
            d = Path(tempfile.mkdtemp())
            try:
                t0 = time.perf_counter()
                fn(sources, d, d / "lib.so")
                print(f"build {name}: {time.perf_counter() - t0:.2f} s "
                      f"({len(sources)} sources, {os.cpu_count()} cores)",
                      flush=True)
            finally:
                shutil.rmtree(d, ignore_errors=True)


if __name__ == "__main__":
    compare_builds(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
