"""Whether two trees compile a kernel to the same machine code: builds
the kernel library of this tree and of another tree's root (each with
its own ``build.load``), disassembles both with ``cuobjdump -sass`` and
compares each kernel's instructions, addresses and encodings left out.
A redesign that leaves an instance alone shows it here byte for byte:

    python -m qavit_tpu_torch.kernels.sass_diff OTHER_ROOT [PATTERN ...]

``PATTERN``: substrings of the demangled kernel names to compare (by
default every kernel both libraries hold; a name only this tree holds
is held against the other's kernels whose names are the same once a
template's trailing bool arguments are dropped, where one tree spells
them out and the other defaults them, and is identical if one of them
is).  Needs the CUDA toolkit
(``nvcc``, ``cuobjdump``, ``cu++filt``); prints one line a kernel and
exits 1 if one differs.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
from pathlib import Path


def _tool(name: str) -> str:
    for cand in (Path("/usr/local/cuda/bin") / name,):
        if cand.exists():
            return str(cand)
    return name


def kernels(so: Path) -> dict:
    """{demangled kernel name: its SASS instructions} of a library."""
    out = subprocess.run([_tool("cuobjdump"), "-sass", str(so)],
                         capture_output=True, text=True, check=True).stdout
    found, name, body = {}, None, []
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            if name:
                found[name] = body
            name, body = m.group(1), []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?);", line)
        if name and m:
            body.append(m.group(1))
    if name:
        found[name] = body
    names = subprocess.run([_tool("cu++filt")], input="\n".join(found),
                           capture_output=True, text=True,
                           check=True).stdout.splitlines()
    return {_canon(d): found[m] for m, d in zip(found, names)}


def _canon(name: str) -> str:
    """A kernel's name without its argument list and the casts in its
    template arguments: ``qv::k<(int)8, (bool)0>(A)`` is ``qv::k<8,
    false>``."""
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    name = re.sub(r"\(bool\)1", "true", re.sub(r"\(bool\)0", "false", name))
    return re.sub(r"\(int\)", "", name)


def _defaulted(name: str) -> str:
    """The name with a template's trailing bool arguments dropped (a
    template of one bool argument, the whole argument list, and the
    return type the demangler gives a template)."""
    name = re.sub(r"(, (true|false))+>", ">", name)
    return re.sub(r"^void (.*)<(true|false)>$", r"\1", name)


def pairs(mine: dict, theirs: dict):
    """(name here, names there) of the kernels both libraries hold: the
    same name, or, for a name only this one holds, the other's kernels
    whose names are the same once a template's trailing bool arguments
    are dropped (an argument one tree spells out and the other
    defaults, or a bool parameter one tree no longer has)."""
    out = [(n, [n]) for n in sorted(mine) if n in theirs]
    rest = [n for n in theirs if n not in mine]
    for n in sorted(set(mine) - set(theirs)):
        match = [o for o in rest if _defaulted(o) == _defaulted(n)]
        if match:
            out.append((n, match))
    return out


def _library(root: Path) -> Path:
    """Build ``root``'s kernel library with its own build module."""
    code = ("from qavit_tpu_torch.kernels import build; "
            "print(build.load().path)")
    env = dict(os.environ, PYTHONPATH=str(root))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, check=True)
    return Path(out.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    args = list(argv if argv is not None else sys.argv[1:])
    if not args:
        print(__doc__)
        return 2
    other, patterns = Path(args[0]).resolve(), args[1:]
    here = Path(__file__).resolve().parents[2]
    mine, theirs = kernels(_library(here)), kernels(_library(other))
    differ = 0
    for name, others in pairs(mine, theirs):
        if patterns and not any(p in name for p in patterns):
            continue
        same = [o for o in others if mine[name] == theirs[o]]
        other_name = (same or others)[0]
        differ += not same
        print(f"sass {name} (there {other_name}): {len(mine[name])} "
              f"instructions here, {len(theirs[other_name])} there, "
              f"{'identical' if same else 'DIFFERENT'}", flush=True)
        if not same:       # the first instructions that differ
            diff = [(i, a, b) for i, (a, b) in
                    enumerate(zip(mine[name], theirs[other_name])) if a != b]
            for i, a, b in diff[:4]:
                print(f"  {i}: here {a} | there {b}", flush=True)
            calls = sum(a.startswith("CALL") and b.startswith("CALL")
                        for _, a, b in diff)
            print(f"  {len(diff)} instructions differ, {calls} of them "
                  f"calls' targets", flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
