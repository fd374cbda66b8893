"""Median device time (ms) of the evaluation (the fused L2P + P2P + M2P
kernel) and the unsort to input order, of the replays that evaluate:
each solve's ``apply``, each half-step's ``apply_plan``
(``repro_torch.trace`` phase marks)."""
from ._spans import phase_ms
from .upward_ms import ENTRIES


def read(run, scope):
    return phase_ms(run, ENTRIES.get(scope, ()), ("evaluation", "unsort"))
