"""Median device time (ms) from the event a program records before
launching its graph to the graph's first node, over every replay of a
solve (``apply``) or a half-step (``refresh`` and ``apply_plan``): the
device's wait for a replay, read without the profiler
(``repro_torch.trace`` phase marks)."""
from ._spans import phase_ms

ENTRIES = {"solve": ("apply",), "step": ("refresh", "apply_plan")}


def read(run, scope):
    return phase_ms(run, ENTRIES.get(scope, ()), ("launch_gap",))
