"""Runs one cell of the benchmark:

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the repository's root, on a machine with as many CUDA cards as the
cell asks for.  Prints, as the last line of standard output, one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each number the
comparison read, with its limit), and the same numbers as the last lines of
standard error.  Exits non-zero, with no result, without the cards, or when
the process holds JAX or the JAX package once the window has closed."""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import harness, registry


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    chips = int(registry.cell(a.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {a.workload} needs {chips} CUDA card(s); this "
              f"machine has {n}", file=sys.stderr)
        return 2
    result = harness.run(a.workload, a.seed, a.seconds, bool(a.trace),
                         device="cuda")
    banned = harness.loaded_banned()
    if banned:
        print(f"portbench: the process holds {', '.join(banned)}",
              file=sys.stderr)
        return 3
    line = json.dumps(result)
    for k, c in result["checks"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
