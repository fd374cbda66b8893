"""Median over the serving plane's waves (``serve::wave`` spans) of the
wave's host time outside the guarded batched applies: its duration minus
its ``serve::apply`` children (admission, the plan cache, padding and
packing, the reports), in ms."""
import statistics

from ._spans import duration_ms, snapshot


def read(run, scope):
    snap = snapshot()
    if snap is None:
        return None
    waves = {s.id: duration_ms(s) for s in snap["spans"]
             if s.name == "serve::wave"}
    for s in snap["spans"]:
        if s.name == "serve::apply" and s.parent in waves:
            waves[s.parent] -= duration_ms(s)
    return statistics.median(waves.values()) if waves else None
