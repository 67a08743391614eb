"""Reads a ``torch.profiler`` trace of the traced slice: the device's
activity (kernels, copies, sets), which of it is the port's kernels, its
busy time, and the idle gaps with the host operation that ran during each.

PyTorch's device operations are told by the name patterns of
``kernels.json``; every other one is the port's."""

from __future__ import annotations

import json
import os
import re
import tempfile
from collections import defaultdict
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SLICE = "portbench.slice"
TOP = 10


def torch_patterns(root: Path) -> list:
    with open(Path(root) / "kernels.json") as f:
        return [re.compile(p) for p in json.load(f)["pytorch"]]


def export(prof) -> dict:
    """The profiler's Chrome trace as a dict; the file goes to TMPDIR and
    is deleted once read."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)
    finally:
        os.unlink(path)


def _merge(spans):
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read(trace: dict, patterns: list) -> dict:
    """The slice's record: ``window_s``, ``busy_s``, ``port_s`` and
    ``other_s`` (device seconds of the port's operations and of PyTorch's,
    which ``patterns`` match), ``port_names`` (the names counted as the
    port's), ``device_ops`` (the ``TOP`` names with the most device time,
    [name, seconds]) and ``idle_gaps`` (the ``TOP`` longest gaps, [host
    operation running during it, seconds]).  Times are clipped to the
    slice, which the annotation ``SLICE`` marks."""
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
    marks = [e for e in events if e.get("name") == SLICE
             and e.get("cat") in ("user_annotation", "cpu_op")]
    if not marks:
        raise RuntimeError(f"the trace has no {SLICE!r} annotation")
    t0 = min(float(e["ts"]) for e in marks)
    t1 = max(float(e["ts"]) + float(e["dur"]) for e in marks)
    by_name = defaultdict(float)
    spans = []
    port = other = 0.0
    port_names = set()
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        s = max(float(e["ts"]), t0)
        t = min(float(e["ts"]) + float(e["dur"]), t1)
        if t <= s:
            continue
        spans.append((s, t))
        name = e.get("name", "")
        by_name[name] += (t - s) * 1e-6
        if any(p.search(name) for p in patterns):
            other += (t - s) * 1e-6
        else:
            port += (t - s) * 1e-6
            port_names.add(name)
    busy = _merge(spans)
    host = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e.get("name", "")) for e in events
                   if e.get("cat") in ("cpu_op", "user_annotation",
                                       "python_function")
                   and e.get("name") != SLICE), key=lambda h: h[0])
    edges = [t0] + [x for s, e in busy for x in (s, e)] + [t1]
    gaps = sorted(((b - a, a, b) for a, b in zip(edges[0::2], edges[1::2])
                   if b > a), reverse=True)[:TOP]
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {"window_s": (t1 - t0) * 1e-6,
            "busy_s": sum(e - s for s, e in busy) * 1e-6,
            "port_s": port, "other_s": other,
            "port_names": sorted(port_names),
            "device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[_host_op(host, (a + b) / 2), g * 1e-6]
                          for g, a, b in gaps]}


def _host_op(host, t) -> str:
    """The innermost host operation that was running at trace time ``t``
    (the shortest one that covers it), else "none"."""
    best = None
    for s, e, name in host:
        if s > t:
            break
        if e >= t and (best is None or e - s < best[0]):
            best = (e - s, name)
    return best[1] if best else "none"
