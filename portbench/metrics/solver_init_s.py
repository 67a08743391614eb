"""solver_init_s: seconds of the solver's own set-up: the program's
``solver.init`` spans (uploads, the initial FillNode2D, the tile plan and
packing of the kernel chunk) and the ``kernels.load`` spans outside them
(nvcc's build of the kernel library, or its load, at the first launch);
its share of setup_s."""


def read(record):
    recs = record.get("spans")
    if not recs:
        return None
    by_id = {r["id"]: r for r in recs}

    def in_init(r):
        while r["parent"] in by_id:
            r = by_id[r["parent"]]
            if r["name"] == "solver.init":
                return True
        return False

    got = [r for r in recs if r["name"] == "solver.init"
           or (r["name"] == "kernels.load" and not in_init(r))]
    if not any(r["name"] == "solver.init" for r in got):
        return None
    return sum((r["end_ns"] - r["start_ns"]) * 1e-9 for r in got)
