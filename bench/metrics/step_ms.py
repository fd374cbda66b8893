"""The window's wall time over the time steps completed in it (ms)."""
from ._window import per_iteration_ms


def read(run, scope):
    return per_iteration_ms(run)
