"""Test-support utilities shipped with the package (not test-only: the
fault-injection smoke walk and operators drilling a deployment use them
too).

  faults  deterministic fault injectors that exercise every rung of the
          guarded-execution recovery ladder (repro_torch.solver.guard)

The reference's serving-plane injectors (``serve_faults``) arrive with
the port of ``serve/``.
"""
from .faults import (force_cap_overflow, nan_coefficients, poison_input,
                     truncate_interaction_lists)

__all__ = [
    "force_cap_overflow", "nan_coefficients", "poison_input",
    "truncate_interaction_lists",
]
