"""chunk_host_ms_per_iter: host milliseconds the program spends issuing a
chunk (its ``solver.chunk`` spans: the enqueue of every launch and the
chunk's torch operations, no wait for the device expected) per inner
iteration, over the window's cycles after the profiled slice (spans on,
profiler off).  Against the device's busy ms an iteration it says how far
ahead of the device the host runs."""


def read(record):
    recs = record.get("spans")
    if not recs:
        return None
    last = max((r["end_ns"] for r in recs if r["traced"]), default=None)
    if last is None:
        return None
    got = [r for r in recs if r["name"] == "solver.chunk"
           and r["start_ns"] > last]
    iters = sum(r["attrs"]["iters"] for r in got)
    if not iters:
        return None
    return sum((r["end_ns"] - r["start_ns"]) * 1e-6 for r in got) / iters
