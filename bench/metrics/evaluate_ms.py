"""Median device time (ms) of the evaluate half on a held plan (upward,
downward, evaluation and the unsort to input order) over every
``apply_charges`` call (``repro_torch.trace`` phase marks)."""
from ._spans import phase_ms
from .charges_ms import ENTRIES


def read(run, scope):
    return phase_ms(run, ENTRIES.get(scope, ()),
                    ("upward", "downward", "evaluation", "unsort"))
