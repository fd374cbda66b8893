"""Median device time (ms) of the downward pass (level-fused M2L, L2L,
P2L) of the replays that evaluate: each solve's ``apply``, each
half-step's ``apply_plan`` (``repro_torch.trace`` phase marks)."""
from ._spans import phase_ms
from .upward_ms import ENTRIES


def read(run, scope):
    return phase_ms(run, ENTRIES.get(scope, ()), ("downward",))
