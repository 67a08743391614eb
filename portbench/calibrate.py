"""The readings that the comparison's limits are set from:

    python -m portbench.calibrate --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...] [--faults <s>] [--out <file>]

One process builds the cell's case (the program's and the reference's)
once; then, for each seed, the cell's solver on that seed's data, a
warm-up cycle, a window of ``seconds``, the program's last call, and the
comparison of both the program and the control (``check.CONTROL``: the
reference in float32 with every carried state stored in bfloat16, put in
the program's place) with the reference.  Prints one JSON line a seed
(``program`` and ``control``: {number: value}, and whether each is
correct under the cell's limits); with ``--faults``, then for each fault
of ``faults.FAULTS`` and each of the first three seeds the program with
that fault planted (a window of that many seconds), judged alike; with
``--out`` also appends the lines to that file.  Runs on the CPU as well
(``--device cpu``: the kernel path's plain versions), where no number is a
device's."""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import check, faults, harness, registry


def _emit(row, rows, out):
    rows.append(row)
    line = json.dumps(row)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def readings(cell_name: str, seeds, seconds: float, device="cuda",
             root=registry.ROOT, out=None, fault_seconds=None):
    from openhyperflow2d_torch.config.deck import load_deck
    from openhyperflow2d_torch.solver.init import build_case
    cell = registry.cell(cell_name, root)
    tr, limits = cell["traffic"], cell["limits"]
    case = build_case(load_deck(cell["config"]["deck_path"]),
                      dtype=cell["config"]["dtype"])
    base = check.reference_build(cell, device)

    def program(seed, secs):
        solver = harness.make_solver(case, cell, seed, device)
        init = check.snapshot(solver.state)
        solver.run_cycle()
        cycles, _, failed, _ = harness.window(solver, secs, None, device)
        if not harness.finite_state(solver):
            failed += 1
        prog = check.collect(solver, int(tr["check_iters"]), init)
        K = solver.fuse_iters
        del solver
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        rc = check.reference_case(cell, seed, device, base=base)
        return prog, K, rc, cycles, failed

    rows = []
    for seed in seeds:
        t0 = time.perf_counter()
        prog, K, rc, cycles, failed = program(seed, seconds)
        ref = check.Plain(rc, check.REFERENCE, device)
        got = check.numbers(prog, ref, K=K)
        row = {"workload": cell_name, "seed": seed, "cycles": cycles,
               "failed": failed, "program": got,
               "program_correct": check.judge(got, limits, failed)}
        ctl = check.Plain(rc, check.CONTROL, device)
        got = check.numbers(prog, ref, ctl, K=K)
        row.update(control=got, control_correct=check.judge(got, limits))
        row["seconds"] = time.perf_counter() - t0
        del prog, ref, ctl
        _emit(row, rows, out)
    for name, plant in faults.FAULTS.items() if fault_seconds else ():
        for seed in seeds[:3]:
            patch = faults.Patch()
            plant(patch)
            try:
                prog, K, rc, cycles, failed = program(seed, fault_seconds)
            finally:
                patch.undo()
            got = check.numbers(prog, check.Plain(rc, check.REFERENCE,
                                                  device), K=K)
            _emit({"workload": cell_name, "seed": seed, "fault": name,
                   "cycles": cycles, "failed": failed, "program": got,
                   "program_correct": check.judge(got, limits, failed)},
                  rows, out)
            del prog
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", type=float, default=None,
                    help="also plant each fault, with windows this long")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    if a.device == "cuda" and not torch.cuda.is_available():
        print("portbench.calibrate: no CUDA card", file=sys.stderr)
        return 2
    readings(a.workload, a.seeds, a.seconds, a.device, out=a.out,
             fault_seconds=a.faults)
    return 0


if __name__ == "__main__":
    sys.exit(main())
