"""Median device time (ms) of the upward pass (P2M, M2M) of the replays
that evaluate: each solve's ``apply``, each half-step's ``apply_plan``
(``repro_torch.trace`` phase marks)."""
from ._spans import phase_ms

ENTRIES = {"solve": ("apply",), "step": ("apply_plan",)}


def read(run, scope):
    return phase_ms(run, ENTRIES.get(scope, ()), ("upward",))
