"""The program's own spans (``openhyperflow2d_torch.spans``) read against
the traced slice, and the per-layer metrics that read them:

    python -m portbench.spans --workload <cell> --seed <n> --seconds <s>

runs the cell as ``python -m portbench.run ... --trace 1`` does (the same
``harness.run``: set-up, the window with its profiled slice, the
comparison), with the program's spans on from the run's start.  It keeps
the spans of the set-up and the window (not of the comparison), the
launches of the window (``FusedStep.launches``) and the slice's Chrome
trace, and reads ``SPAN_METRICS`` from them (``metrics/<metric>.py``, each
with ``read(record)`` as the harness's readers).  The last line of
standard output is the run's result with those metrics added to
``metrics``, ``by_span`` (the attribution below, ms per cycle of the
slice; the longest idle gaps by span; ``host_by_span``, each span's host
ms a cycle after the slice) and ``gcups_after_slice`` (the window's gcups
over its cycles after the slice, where the spans are on and the profiler
off: the cost of the spans, against the gcups of runs without the trace).
This run path stands in until the harness's own ``--trace 1`` run turns
the spans on and hands their records to the readers (PERF.md §7 item 3);
then ``run`` and ``main`` go, and ``attribute`` and the readers stay.

``attribute`` reads the spans of the slice from the trace itself: under
the profiler each enabled span is a ``user_annotation`` event.  It splits
the slice three ways: the device's idle time by the innermost span the
host was in (``idle``, "outside" where it was in none), the device time of
PyTorch's operations and of the port's by the innermost span around the
runtime call that launched each (``glue``, ``port``; matched by
``args.correlation``, "unmatched" where no call has its correlation).  The
idle split is also taken from the second cycle of the slice on
(``idle_later``): the profiler's start lands in the first.  The in-memory
records serve only outside the profiler (set-up, and the host time after
the slice).  A program without spans (an older checkout) leaves these
metrics out."""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from pathlib import Path

from . import harness, registry, trace

# {metric: unit} of the metrics this module reads
SPAN_METRICS = {"wall_distance_s": "s", "solver_init_s": "s",
                "chunk_host_ms_per_iter": "ms", "program_idle_pct": "%",
                "launches_per_iter": "launches"}
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
OUTSIDE, UNMATCHED = "outside", "unmatched"


def program_spans():
    """The program's span module, or None where the program has none."""
    try:
        from openhyperflow2d_torch import spans
    except ImportError:
        return None
    return spans


def _innermost(spans_us, t):
    """The name of the innermost span of ``spans_us`` ((start, end, name),
    trace µs, properly nested) that covers ``t``: the one that starts last,
    else ``OUTSIDE``."""
    best = None
    for s, e, name in spans_us:
        if s <= t <= e and (best is None or (s, -e) > best[:2]):
            best = (s, -e, name)
    return best[2] if best else OUTSIDE


def attribute(tr: dict, names, patterns: list) -> dict:
    """The slice of Chrome trace ``tr`` (marked by ``trace.SLICE``) split
    by the program's spans, the trace's ``user_annotation`` events named
    in ``names``: {"idle", "glue", "port": {span: seconds}}, "cycles" (the
    ``solver.cycle`` spans that start in the slice), "idle_later" and
    "later_s" (the idle split, and the seconds, from the start of the
    slice's second cycle to its end; empty and 0 with fewer cycles),
    "window_s" (the slice's seconds) and "gaps" (the ``trace.TOP``
    longest idle gaps, [the innermost span at the gap's middle, the index
    of its cycle in the slice (None outside a cycle), the innermost
    PyTorch operation there, seconds])."""
    events = [e for e in tr.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
    marks = [e for e in events if e.get("name") == trace.SLICE]
    if not marks:
        raise RuntimeError(f"the trace has no {trace.SLICE!r} annotation")
    t0 = min(float(e["ts"]) for e in marks)
    t1 = max(float(e["ts"]) + float(e["dur"]) for e in marks)

    inside = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                     e["name"]) for e in events
                    if e.get("cat") == "user_annotation"
                    and e.get("name") in names)
    inside = [x for x in inside if x[1] >= t0 and x[0] <= t1]
    cycles = [(s, e) for s, e, n in inside
              if n == "solver.cycle" and t0 <= s <= t1]
    later = cycles[1][0] if len(cycles) > 1 else t1

    def cycle_of(t):
        return next((i for i, (s, e) in enumerate(cycles) if s <= t <= e),
                    None)

    device, runtime = [], {}
    for e in events:
        cat = e.get("cat")
        corr = (e.get("args") or {}).get("correlation")
        if cat in RUNTIME_CATS and corr is not None:
            runtime[corr] = float(e["ts"])
        elif cat in trace.DEVICE_CATS:
            s = max(float(e["ts"]), t0)
            t = min(float(e["ts"]) + float(e["dur"]), t1)
            if t > s:
                device.append((s, t, e.get("name", ""), corr))

    glue, port = defaultdict(float), defaultdict(float)
    for s, t, name, corr in device:
        to = glue if any(p.search(name) for p in patterns) else port
        key = (_innermost(inside, runtime[corr]) if corr in runtime
               else UNMATCHED)
        to[key] += (t - s) * 1e-6

    idle, idle_later = defaultdict(float), defaultdict(float)
    busy = trace._merge([(s, t) for s, t, _, _ in device])
    edges = [t0] + [x for s, e in busy for x in (s, e)] + [t1]
    cuts = sorted({x for s, e, _ in inside for x in (s, e)} | {later})
    gaps = []
    for a, b in zip(edges[0::2], edges[1::2]):
        pts = [a] + [c for c in cuts if a < c < b] + [b]
        for u, v in zip(pts, pts[1:]):
            if v > u:
                name = _innermost(inside, (u + v) / 2)
                idle[name] += (v - u) * 1e-6
                if u >= later:
                    idle_later[name] += (v - u) * 1e-6
        if b > a:
            gaps.append((b - a, (a + b) / 2))

    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e.get("name", "")) for e in events
                  if e.get("cat") in ("cpu_op", "python_function"))
    gaps = [[_innermost(inside, t), cycle_of(t), trace._host_op(host, t),
             g * 1e-6] for g, t in sorted(gaps, reverse=True)[:trace.TOP]]
    return {"idle": dict(idle), "glue": dict(glue), "port": dict(port),
            "cycles": len(cycles), "idle_later": dict(idle_later),
            "window_s": (t1 - t0) * 1e-6, "later_s": (t1 - later) * 1e-6,
            "gaps": gaps}


def per_cycle_ms(by_span: dict) -> dict:
    """``attribute``'s splits in ms per cycle of the slice (``idle_later``
    per cycle after the first), each sorted by its largest share."""
    n = by_span["cycles"]
    return {f"{k}_by_span": {name: s * 1e3 / max(m, 1) for name, s in
                             sorted(by_span[k].items(),
                                    key=lambda kv: -kv[1])}
            for k, m in (("idle", n), ("glue", n), ("port", n),
                         ("idle_later", n - 1))}


def host_ms_per_cycle(recs: list) -> dict:
    """Host ms a cycle of each span name over the cycles after the last
    span that ran under the profiler, largest first."""
    last = max((r["end_ns"] for r in recs if r["traced"]), default=None)
    after = [r for r in recs if last is not None and r["start_ns"] > last
             and r["cycle"] is not None]
    n = sum(1 for r in after if r["name"] == "solver.cycle")
    tot = defaultdict(float)
    for r in after:
        tot[r["name"]] += (r["end_ns"] - r["start_ns"]) * 1e-6
    return {k: v / n for k, v in sorted(tot.items(), key=lambda kv: -kv[1])
            } if n else {}


def read_metrics(record: dict, root: Path = registry.ROOT) -> dict:
    """{metric: {"value", "unit"}} of ``SPAN_METRICS`` that find something
    to read in ``record``."""
    out = {}
    for name, unit in SPAN_METRICS.items():
        mod = registry._module(Path(root) / "metrics" / f"{name}.py",
                               f"portbench_metric_{name}")
        v = mod.read(record)
        if v is not None:
            out[name] = {"value": v, "unit": unit}
    return out


def _launches(solver):
    fused = getattr(solver, "fused", None)
    return sum(fused.launches.values()) if fused is not None else None


def run(cell_name: str, seed: int, seconds: float, device="cuda",
        root: Path = registry.ROOT, log=sys.stderr) -> dict:
    """``harness.run`` of the cell with the trace on and the program's
    spans on; returns its result with the span metrics added."""
    prog = program_spans()
    got = {}
    window0, read0 = harness.window, trace.read

    def window(solver, seconds, trace_slice=None, device="cuda"):
        n0 = _launches(solver)
        out = window0(solver, seconds, trace_slice, device)
        n1 = _launches(solver)
        got.update(launches=None if n0 is None else n1 - n0,
                   spans=prog.records() if prog else None,
                   iters=out[0] * solver.case.Nstep,
                   after=(out[0] - sum(trace_slice)) * solver.case.Nstep,
                   nodes=solver.params.MaxX * solver.params.MaxY,
                   window_s=out[1])
        return out

    def read(tr, patterns):
        got.update(trace=tr, patterns=patterns, slice=read0(tr, patterns))
        return got["slice"]

    if prog is not None:
        prog.reset()
        prog.enable()
    harness.window, trace.read = window, read
    try:
        result = harness.run(cell_name, seed, seconds, True, device=device,
                             root=root, log=log)
    finally:
        harness.window, trace.read = window0, read0
        if prog is not None:
            prog.disable()

    sl = dict(got["slice"])
    if prog is not None:
        sl["by_span"] = attribute(got["trace"],
                                  {r["name"] for r in got["spans"]},
                                  got["patterns"])
    record = {"spans": got["spans"], "launches": got["launches"],
              "iters": got["iters"], "trace": sl}
    checks = result.pop("checks")
    result["metrics"].update(read_metrics(record, root))
    if prog is not None:
        by = {**per_cycle_ms(sl["by_span"]), "gaps": sl["by_span"]["gaps"],
              "host_by_span": host_ms_per_cycle(got["spans"])}
        whole = sl["by_span"]["idle"]
        print(json.dumps({**by, "cycles": sl["by_span"]["cycles"],
                          "program_idle_pct_slice": 100.0 * sum(
                              v for k, v in whole.items() if k != OUTSIDE)
                          / sl["by_span"]["window_s"],
                          "dropped": prog.dropped()}), file=log)
        result["by_span"] = by
    result["gcups_after_slice"] = (got["nodes"] * got["after"]
                                / got["window_s"] / 1e9)
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    a = ap.parse_args(argv)
    result = run(a.workload, a.seed, a.seconds)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
