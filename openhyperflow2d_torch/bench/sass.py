"""SASS opcode counts of the kernels as built for the card: ``cuobjdump
-sass`` of the kernel library.  The microbenchmark kernels
(ops/csrc/microbench.cu): each ``shift_chain``/``div_chain``
instantiation's whole function and, for ``div_chain``, each innermost loop
(a backward branch holding no other) over its DIV_UNROLL x DIV_EPT op
steps, which gives the counts a step.  The solver's gfc and pass12 kernels
(ops/csrc/fused_step*.cu): each instantiation's whole function (its
global and shared loads, the MUFU and FCHK of its divisions, the CALLs to
the division's slow path, its local loads and stores).

    python -m openhyperflow2d_torch.bench.sass [--tree TREE] [NAME ...]

builds the library if needed (nvcc; of TREE's ops/csrc with ``--tree``)
and prints one line a kernel, those whose name contains one of the NAMEs
if any are given.  It exits non-zero where cuobjdump is not beside nvcc.

    python -m openhyperflow2d_torch.bench.sass --spills [NAME ...]

reads where the solver's kernels spill: it builds the library with
``-lineinfo`` (line tables only: ptxas gives the same registers and
spills), disassembles it with nvdisasm and prints one line a local-memory
slot of each kernel: each store with the instruction that last wrote the
stored register and its source line, each load with the first
instruction that reads the loaded register and its line (spills).
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
from pathlib import Path

from . import microbench as mb

# mangled names in cuobjdump's listing: shift_chain<AXIS, WRAP>,
# div_chain<OP, VEC>
_KERNEL = re.compile(r"(shift|div)_chainILi(\d)ELb([01])E")
# the solver's kernels: <kind>_kernel<BODY>
_FUSED = re.compile(r"_Z\d+((?:gfc|pass12)\w*?_kernel)ILi(\d)E")
# the spec tiles' fused iteration (fused_step_spec.cu), no template
_SPEC = re.compile(r"_Z\d+(step_spec_kernel)6Consts")
_BODY = {"0": "general", "1": "spec", "2": "dual", "3": "staged"}
_INST = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_BACK = re.compile(r"\bBRA\S*\s+(?:\S+\s+)?`?\(?(0x[0-9a-f]+)")
OPS = ("MUFU", "FFMA", "FMUL", "FADD", "FCHK", "FSETP", "ISETP", "PLOP3",
       "CALL", "BRA", "LDG", "STG", "LDS", "STS", "LDL", "STL", "BAR",
       "SHFL")


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
    microbenchmark kernels in a cuobjdump -sass listing, and of the
    solver's kernels under ("fused", name, body)."""
    funcs, cur = {}, None
    for line in listing.splitlines():
        if "Function :" in line:
            m = _KERNEL.search(line)
            f = _FUSED.search(line)
            g = _SPEC.search(line)
            cur = (m.groups() if m else
                   ("fused", f.group(1), _BODY[f.group(2)]) if f else
                   ("fused", g.group(1), None) if g else None)
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
        if kind == "fused":
            whole = counts(t for _, t in insts)
            name = arg if flag is None else f"{arg}<{flag}>"
            lines.append(f"{name}: {len(insts)} instructions, "
                         + ", ".join(f"{k} {v}" for k, v in whole.items()
                                     if v))
            continue
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


# nvdisasm -g: a function's label, an instruction's source line
_NVD_FUNC = re.compile(r"^\.text\.(_Z\w+):")
_NVD_LINE = re.compile(r'//## File "([^"]+)", line (\d+)')
# a local store or load through the stack pointer: STL [R1+off], Rs and
# LDL Rd, [R1+off] (any width; the first register of a pair)
_STL = re.compile(r"^STL(?:\.\w+)*\s+\[R1(?:\+(0x[0-9a-f]+))?\],\s*(R\d+)")
_LDL = re.compile(r"^LDL(?:\.\w+)*\s+(R\d+),\s*\[R1(?:\+(0x[0-9a-f]+))?\]")
# opcodes whose first operand is not a register they write
_NO_DEST = ("ST", "BRA", "BSSY", "BSYNC", "EXIT", "RED", "CALL", "RET",
            "BAR", "WARPSYNC", "NOP")


def line_functions(listing: str) -> dict:
    """{"name<body>": [(address, instruction, "file:line")]} of the
    solver's kernels in an ``nvdisasm -g`` listing (a predicate guard kept
    in the instruction)."""
    funcs, cur, where = {}, None, "?"
    for line in listing.splitlines():
        m = _NVD_FUNC.match(line)
        if m:
            f = _FUSED.search(m.group(1))
            g = _SPEC.search(m.group(1))
            cur = (f"{f.group(1)}<{_BODY[f.group(2)]}>" if f else
                   g.group(1) if g else None)
            if cur:
                funcs[cur] = []
            continue
        m = _NVD_LINE.search(line)
        if m:
            where = f"{Path(m.group(1)).name}:{m.group(2)}"
            continue
        m = _INST.match(line)
        if m and cur:
            funcs[cur].append((int(m.group(1), 16), m.group(2), where))
    return funcs


def _unguarded(text: str) -> str:
    return re.sub(r"^@!?U?P\w+\s+", "", text)


def _operands(text: str) -> list:
    return re.split(r"[\s,\[\]]+", _unguarded(text).strip())


def _writes(text: str, reg: str) -> bool:
    ops = _operands(text)
    return (len(ops) > 1 and not ops[0].startswith(_NO_DEST)
            and ops[1] == reg)


def spills(insts) -> list:
    """One line a local-memory slot of a function (line_functions), by
    offset: each store, with the last instruction before it that wrote the
    stored register (the spilled value's origin), and each load, with the
    first instruction after it that reads the loaded register (its use);
    "?" where the listing holds none."""
    slots = {}
    for k, (addr, text, where) in enumerate(insts):
        body = _unguarded(text)
        m = _STL.match(body)
        if m:
            off, reg = int(m.group(1) or "0", 16), m.group(2)
            src = next((f"{t.split()[0]} at {a:#06x} ({w})"
                        for a, t, w in reversed(insts[:k])
                        if _writes(t, reg)), "?")
            slots.setdefault(off, []).append(
                f"stored at {addr:#06x} ({where}) from {src}")
            continue
        m = _LDL.match(body)
        if m:
            reg, off = m.group(1), int(m.group(2) or "0", 16)
            use = next((f"{_unguarded(t).split()[0]} at {a:#06x} ({w})"
                        for a, t, w in insts[k + 1:]
                        if reg in _operands(t)[1:]), "?")
            slots.setdefault(off, []).append(
                f"loaded at {addr:#06x} ({where}), read by {use}")
    return [f"local +{off:#x}: " + "; ".join(v)
            for off, v in sorted(slots.items())]


def spill_report(lib: Path, nvdisasm: Path, cuobjdump: Path) -> dict:
    """line_functions of every cubin of the library ``lib``."""
    import tempfile
    funcs = {}
    with tempfile.TemporaryDirectory() as tmp:
        subprocess.run([str(cuobjdump), "-xelf", "all", str(lib)], cwd=tmp,
                       capture_output=True, check=True)
        for cubin in sorted(Path(tmp).glob("*.cubin")):
            funcs.update(line_functions(subprocess.run(
                [str(nvdisasm), "-g", "-c", str(cubin)], capture_output=True,
                text=True, check=True).stdout))
    return funcs


def main() -> int:
    from ..ops.build import CSRC, load_library, nvcc_path
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", help="report TREE's ops/csrc build instead")
    ap.add_argument("--spills", action="store_true",
                    help="where each kernel spills (a -lineinfo build)")
    ap.add_argument("names", nargs="*",
                    help="only the kernels whose name holds one of these")
    args = ap.parse_args()
    tools = Path(nvcc_path()).parent
    cuobjdump = tools / "cuobjdump"
    for tool in (cuobjdump, tools / "nvdisasm") if args.spills else (
            cuobjdump,):
        if not tool.exists():
            print(f"sass: {tool} not found", file=sys.stderr)
            return 2
    csrc = Path(args.tree) / "openhyperflow2d_torch/ops/csrc" \
        if args.tree else CSRC
    if args.spills:
        lib = load_library(csrc, flags=("-lineinfo",)).path
        for name, insts in sorted(spill_report(lib, tools / "nvdisasm",
                                               cuobjdump).items()):
            if not args.names or any(n in name for n in args.names):
                for line in spills(insts) or ["no local memory"]:
                    print(f"{name}: {line}")
        return 0
    listing = subprocess.run([str(cuobjdump), "-sass",
                              str(load_library(csrc).path)],
                             capture_output=True, text=True,
                             check=True).stdout
    for line in report(listing):
        if not args.names or any(n in line.split(":")[0]
                                 for n in args.names):
            print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
