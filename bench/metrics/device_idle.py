"""The device's idle share (%) of the traced slice: 1 - (the union of the
intervals in which a device operation ran) / (the slice's length)."""


def read(run, scope):
    d = run.digest
    if d is None or d.window_s <= 0:
        return None
    return 100.0 * (1.0 - d.busy_s / d.window_s)
