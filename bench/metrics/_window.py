"""Readings of the window that several metrics share."""
from __future__ import annotations

import statistics


def per_iteration_ms(run) -> float | None:
    """The window's wall time over the iterations completed in it (ms)."""
    n = run.readings.get("iterations")
    if not n:
        return None
    return 1e3 * run.readings["window_s"] / n


def median_ms(run, key: str) -> float | None:
    values = run.readings.get(key)
    if not values:
        return None
    return 1e3 * statistics.median(values)
