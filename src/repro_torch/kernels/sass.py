"""Static SASS instruction counts of a kernel's hot loop, per `expf`.

    PYTHONPATH=src python -m repro_torch.kernels.sass [LIB] [--kernel NAME]

Disassembles the built kernel library (`cuobjdump -sass`; default
`build/repro_torch/libnebula_kernels.so`) and, for each function whose
name holds NAME (default `rasterize_kernel`), finds the loop (a backward
branch) with the most `MUFU.EX2` instructions of its own, not counting
those of loops nested in it. It reports that loop's instructions (nested
loops counted once) over those `MUFU.EX2`: for K2, whose `expf` makes one
`MUFU.EX2` a pixel and entry, the instructions a pixel-entry costs.
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess

_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_TARGET = re.compile(r"\bBRA\b.*?(0x[0-9a-f]+|`?\(?(\.L_x_\d+)\)?`?)")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")


def find_cuobjdump() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("cuobjdump"), os.path.join(cuda_home, "bin", "cuobjdump")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("cuobjdump not found")


def functions(sass: str) -> dict:
    """{function name: [(address, instruction text)]} from `cuobjdump -sass`."""
    out, name, labels, pending = {}, None, {}, []
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name], labels[name] = [], {}
            continue
        if name is None:
            continue
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSTR.search(line)
        if m:
            addr = int(m.group(1), 16)
            for lab in pending:
                labels[name][lab] = addr
            pending = []
            out[name].append((addr, m.group(2)))
    return {n: (ins, labels[n]) for n, ins in out.items()}


def hot_loop(instrs, labels) -> dict:
    """The loop with the most MUFU.EX2 of its own: {'instructions', 'ex2',
    'per_ex2', 'start', 'end'} (addresses in bytes), or None."""
    loops = []
    for addr, text in instrs:
        m = _TARGET.search(text)
        if not m:
            continue
        tgt = int(m.group(1), 16) if m.group(1).startswith("0x") else labels.get(m.group(2))
        if tgt is not None and tgt <= addr:
            loops.append((tgt, addr))
    best = None
    for lo, hi in loops:
        inner = [(a, b) for a, b in loops if lo <= a and b <= hi and (a, b) != (lo, hi)]
        body = [(a, t) for a, t in instrs if lo <= a <= hi]
        own = [a for a, t in body if "MUFU.EX2" in t
               and not any(x <= a <= y for x, y in inner)]
        if own and (best is None or len(own) > best["ex2"]):
            best = dict(instructions=len(body), ex2=len(own),
                        per_ex2=len(body) / len(own), start=lo, end=hi)
    return best


def report(lib: str, kernel: str = "rasterize_kernel") -> list:
    """One row per function whose name holds `kernel`: its name, its
    instruction count, and its hot loop (see `hot_loop`)."""
    sass = subprocess.run([find_cuobjdump(), "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    rows = []
    for name, (instrs, labels) in functions(sass).items():
        if kernel in name:
            rows.append(dict(function=name, instructions=len(instrs),
                             loop=hot_loop(instrs, labels)))
    return rows


def main() -> None:
    from repro_torch.kernels._build import BUILD_DIR, LIB_NAME
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("lib", nargs="?", default=str(BUILD_DIR / LIB_NAME))
    ap.add_argument("--kernel", default="rasterize_kernel")
    args = ap.parse_args()
    for row in report(args.lib, args.kernel):
        loop = row["loop"]
        print(f"{row['function']}: {row['instructions']} instructions; hot loop "
              + (f"{loop['instructions']} instructions over {loop['ex2']} MUFU.EX2 = "
                 f"{loop['per_ex2']:.2f} a pixel-entry" if loop else "none"))


if __name__ == "__main__":
    main()
