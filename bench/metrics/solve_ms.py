"""The window's wall time over the solves completed in it (ms): what a
caller that waits for each answer sees a solve take."""
from ._window import per_iteration_ms


def read(run, scope):
    return per_iteration_ms(run)
