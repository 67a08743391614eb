"""SASS opcode counts of the microbenchmark kernels (ops/csrc/microbench.cu)
as built for the card: ``cuobjdump -sass`` of the kernel library, each
``shift_chain``/``div_chain`` instantiation's whole function and, for
``div_chain``, each innermost loop (a backward branch holding no other)
over its DIV_UNROLL x DIV_EPT op steps, which gives the counts a step.

    python -m openhyperflow2d_torch.bench.sass

builds the library if needed (nvcc) and prints one line a kernel.  It exits
non-zero where cuobjdump is not beside nvcc.
"""

from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

from . import microbench as mb

# mangled names in cuobjdump's listing: shift_chain<AXIS, WRAP>,
# div_chain<OP, VEC>
_KERNEL = re.compile(r"(shift|div)_chainILi(\d)ELb([01])E")
_INST = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_BACK = re.compile(r"\bBRA\S*\s+(?:\S+\s+)?`?\(?(0x[0-9a-f]+)")
OPS = ("MUFU", "FFMA", "FMUL", "FADD", "FCHK", "FSETP", "ISETP", "PLOP3",
       "CALL", "BRA", "LDG", "STG", "LDS", "STS", "BAR", "SHFL")


def counts(insts) -> dict:
    """Counts of the opcodes of OPS (by the stem before the first dot) in
    SASS instruction texts, a predicate guard ignored."""
    out = dict.fromkeys(OPS, 0)
    for text in insts:
        op = re.sub(r"^@!?U?P\w+\s+", "", text).split()[0].split(".")[0]
        if op in out:
            out[op] += 1
    return out


def functions(listing: str) -> dict:
    """{(kind, template argument, flag): [(address, instruction)]} of the
    microbenchmark kernels in a cuobjdump -sass listing."""
    funcs, cur = {}, None
    for line in listing.splitlines():
        if "Function :" in line:
            m = _KERNEL.search(line)
            cur = m.groups() if m else None
            if cur:
                funcs[cur] = []
            continue
        m = _INST.match(line)
        if m and cur:
            funcs[cur].append((int(m.group(1), 16), m.group(2)))
    return funcs


def inner_loops(insts) -> list:
    """(first, last address) of each loop that holds no other loop, in
    address order."""
    loops = []
    for addr, text in insts:
        m = _BACK.search(text)
        if m and int(m.group(1), 16) < addr:
            loops.append((int(m.group(1), 16), addr))
    return sorted((lo, hi) for lo, hi in loops
                  if not any(lo <= a and b <= hi and (a, b) != (lo, hi)
                             for a, b in loops))


def report(listing: str) -> list:
    """One line a kernel: its instruction and opcode counts and, for
    div_chain, each innermost loop's counts a chain step (the chain's loop,
    then for div, exact rcp and sqrt the rerun on nvcc's ops)."""
    lines = []
    for (kind, arg, flag), insts in sorted(functions(listing).items()):
        if kind == "div" and flag == "0":
            continue    # the element-load form; the scripts' blocks align
        name = (mb.shift_name(int(arg), flag == "1") if kind == "shift"
                else mb.div_name(mb.DIV_OPS[int(arg)]))
        whole = counts(t for _, t in insts)
        msg = (f"{name}: {len(insts)} instructions, "
               + ", ".join(f"{k} {v}" for k, v in whole.items() if v))
        if kind == "div":
            steps = mb.DIV_UNROLL * mb.DIV_EPT
            for lo, hi in inner_loops(insts):
                body = counts(t for a, t in insts if lo <= a <= hi)
                msg += (f"; loop at {lo:#x}, a step of its {steps}: "
                        f"{(hi - lo + 16) / 16 / steps:g} instructions, "
                        + ", ".join(f"{k} {v / steps:g}"
                                    for k, v in body.items() if v))
        lines.append(msg)
    return lines


def main() -> int:
    from ..ops.build import load_kernels, nvcc_path
    cuobjdump = Path(nvcc_path()).parent / "cuobjdump"
    if not cuobjdump.exists():
        print(f"sass: {cuobjdump} not found", file=sys.stderr)
        return 2
    listing = subprocess.run([str(cuobjdump), "-sass",
                              str(load_kernels().path)],
                             capture_output=True, text=True,
                             check=True).stdout
    for line in report(listing):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
