"""glue_ms_per_iter: device milliseconds of PyTorch's device operations
in the traced slice (its kernels, copies and sets, by the patterns of
kernels.json: scan_dt, combine, the chunk ends' torch, recalc_y_plus), per
inner iteration."""


def read(record):
    t = record.get("trace")
    if not t or not t["other_s"]:
        return None
    return t["other_s"] * 1e3 / t["iters"]
