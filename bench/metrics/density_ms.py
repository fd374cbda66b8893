"""Median device time (ms) of the evaluate half on a held plan (upward,
downward, evaluation and the unsort, ``evaluate_ms``) a density: over
the densities each call evaluated, read from the rise of the port's
counter ``fmm.densities`` over the window's calls. None for a port
without the counter."""
from ._spans import phase_ms
from .charges_ms import ENTRIES


def read(run, scope):
    ms = phase_ms(run, ENTRIES.get(scope, ()),
                  ("upward", "downward", "evaluation", "unsort"))
    dens, calls = run.readings.get("densities"), run.readings.get(
        "iterations")
    if ms is None or not dens or not calls:
        return None
    return ms / (dens / calls)
