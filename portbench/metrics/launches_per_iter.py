"""launches_per_iter: the port's kernel launches over the window (the
program's counter ``FusedStep.launches``) per inner iteration."""


def read(record):
    n = record.get("launches")
    if n is None or not record.get("iters"):
        return None
    return n / record["iters"]
