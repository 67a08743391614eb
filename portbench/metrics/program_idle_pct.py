"""program_idle_pct: the share of the traced slice from its second cycle
on, in percent, in which the card was idle while the host was inside one
of the program's spans (the idle time outside every span left out).  The
slice's first cycle is left out because the profiler's start lands in
it."""


def read(record):
    t = record.get("trace")
    by = t.get("by_span") if t else None
    if not by or not by["later_s"]:
        return None
    inside = sum(s for k, s in by["idle_later"].items() if k != "outside")
    return 100.0 * inside / by["later_s"]
