"""kernel_ms_per_iter: device milliseconds of the port's own operations
(every device operation that the PyTorch patterns of kernels.json do not
match) in the traced slice, per inner iteration."""


def read(record):
    t = record.get("trace")
    if not t or not t["port_s"]:
        return None
    return t["port_s"] * 1e3 / t["iters"]
