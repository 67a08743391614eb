"""step_roofline_pct: the least time of one iteration's work (the bytes
that work/ counts per class of node, each input plane read once and each
output plane written once) at the card's published HBM bandwidth
(peaks.json), over the device-busy time per iteration of the traced
slice, in percent.  Operations are not counted, so it is a lower bound of
the share of the roofline.  Nothing where work/ does not count the deck's
physics."""


def read(record):
    t = record.get("trace")
    if not t or not t["busy_s"] or not t["work_bytes"]:
        return None
    work = sum(t["work_bytes"].values())
    if not work:
        return None
    least_s = work / t["peaks"]["hbm_bytes_per_s"]
    return 100.0 * least_s / (t["busy_s"] / t["iters"])
