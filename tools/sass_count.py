"""Count the SASS instructions of the port's kernels in the built library.

Run from a checkout's root, on a machine with the CUDA toolkit, after the
library is built (any first kernel launch builds it):

    python3 tools/sass_count.py OUT_DIR [substring ...]

For each kernel whose mangled name holds one of the substrings (all kernels
without any), it writes the kernel's SASS to ``OUT_DIR/<name>.sass`` and
prints one JSON line: its instructions (NOPs left out), those inside its
loops (the ranges that a backward branch closes, outermost first), those
of its outermost loop off the slow paths, and its instructions by opcode.
A slow path is the code that a conditional forward branch skips when that
code touches local memory, calls a subroutine or multiplies in double
(``cosf``'s Payne-Hanek reduction, ``sqrtf``'s special values): what a
loop iteration issues when no such branch falls through. The other counts
are static.
"""

import collections
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, os.getcwd())

from lb2d_tpu_torch.ops._build import LIB_PATH  # noqa: E402

_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?);")
_TARGET = re.compile(r"BRA\s.*?(?:0x([0-9a-f]+)|`\(\.L_x_(\d+)\))")
_LABEL = re.compile(r"^\s*\.L_x_(\d+):")
# what marks a skipped block as a slow path: local memory, a call, or a
# double-precision product (the Payne-Hanek reduction keeps its words in
# registers or in local memory, but scales its result in double)
_SLOW = ("LDL", "STL", "CALL", "DMUL")


def _cuobjdump():
    found = shutil.which("cuobjdump")
    if found:
        return found
    return str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin"
               / "cuobjdump")


def _kernels(sass):
    """(name, lines) of each function in cuobjdump's listing."""
    name, lines = None, []
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            if name:
                yield name, lines
            name, lines = m.group(1), []
        elif name:
            lines.append(line)
    if name:
        yield name, lines


def _count(lines):
    """Instructions, their addresses, opcodes and loop ranges."""
    instrs, labels, branches = [], {}, []  # branches: (addr, target, cond)
    for line in lines:
        lab = _LABEL.match(line)
        if lab:
            labels[lab.group(1)] = None  # the next instruction's address
            continue
        m = _INSTR.search(line)
        if not m:
            continue
        addr, text = int(m.group(1), 16), m.group(2).strip()
        for key, val in labels.items():
            if val is None:
                labels[key] = addr
        op = re.sub(r"^@!?U?P[T0-9]+\s+", "", text).split()[0]
        instrs.append((addr, op))
        b = _TARGET.search(text)
        if b:
            branches.append((addr, b.group(1), b.group(2),
                             text.startswith("@")))
    loops, slow = [], []
    real = [(a, op) for a, op in instrs if op != "NOP"]
    for addr, hexa, label, cond in branches:
        target = int(hexa, 16) if hexa else labels.get(label)
        if target is None:
            continue
        if target <= addr:
            loops.append((target, addr))
        elif cond and any(addr < a < target and op.startswith(_SLOW)
                          for a, op in real):
            slow.append((addr, target))
    loops.sort(key=lambda r: r[0] - r[1])
    in_loops = [sum(lo <= a <= hi for a, _ in real) for lo, hi in loops]
    fast = [sum(lo <= a <= hi and not any(b < a < t for b, t in slow
                                          if lo <= b and t <= hi)
                for a, _ in real) for lo, hi in loops[:1]]
    return {"instructions": len(real), "loop_instructions": in_loops,
            "fast_loop_instructions": fast[0] if fast else None,
            "opcodes": dict(collections.Counter(op for _, op in real)
                            .most_common())}


def main():
    out_dir = Path(sys.argv[1])
    wanted = sys.argv[2:]
    out_dir.mkdir(parents=True, exist_ok=True)
    sass = subprocess.run([_cuobjdump(), "-sass", str(LIB_PATH)], check=True,
                          capture_output=True, text=True).stdout
    for name, lines in _kernels(sass):
        if wanted and not any(w in name for w in wanted):
            continue
        (out_dir / f"{name[:120]}.sass").write_text("\n".join(lines))
        print(json.dumps({"kernel": name, **_count(lines)}), flush=True)


if __name__ == "__main__":
    main()
