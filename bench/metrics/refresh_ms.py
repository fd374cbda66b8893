"""Median host-clock time (ms) of one ``GuardedSolver.refresh_guarded``
(tree, connectivity and the guard's read of the margins) outside the
traced slice of a traced run."""
from ._window import median_ms


def read(run, scope):
    return median_ms(run, "refresh_s")
