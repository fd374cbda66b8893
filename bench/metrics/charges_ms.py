"""Median device time (ms) of the gather of new charges into a held
plan's order (phase ``fmm::charges``) over every ``apply_charges`` call
(``repro_torch.trace`` phase marks)."""
from ._spans import phase_ms

ENTRIES = {"matvec": ("apply_charges",)}


def read(run, scope):
    return phase_ms(run, ENTRIES.get(scope, ()), ("charges",))
