"""device_idle_pct: the share of the traced slice in which no operation
ran on the card, in percent."""


def read(record):
    t = record.get("trace")
    if not t or not t["window_s"] or not t["busy_s"]:
        return None
    return 100.0 * (t["window_s"] - t["busy_s"]) / t["window_s"]
