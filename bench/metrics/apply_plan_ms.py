"""Median host-clock time (ms) of one ``apply_plan`` (upward, downward,
evaluation), ending in a synchronize, outside the traced slice of a
traced run."""
from ._window import median_ms


def read(run, scope):
    return median_ms(run, "apply_plan_s")
