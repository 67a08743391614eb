"""gcups: node updates per second over the window, in billions: MaxX x
MaxY x the inner iterations the window completed / its seconds on the
host clock (ending at the last cycle's copy of its diagnostics)."""


def read(record):
    return record.get("gcups")
