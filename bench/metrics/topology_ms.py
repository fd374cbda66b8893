"""Median device time (ms) of the topology (tree and connectivity) of
the replays that build a plan: each solve's ``apply``, each half-step's
``refresh`` (``repro_torch.trace`` phase marks)."""
from ._spans import phase_ms

ENTRIES = {"solve": ("apply",), "step": ("refresh",)}


def read(run, scope):
    return phase_ms(run, ENTRIES.get(scope, ()), ("tree", "connectivity"))
