"""Test-support utilities shipped with the package (not test-only: the
fault-injection smoke walk, the serving soak and operators drilling a
deployment use them too).

  faults        deterministic fault injectors that exercise every rung
                of the guarded-execution recovery ladder
                (repro_torch.solver.guard)
  serve_faults  serving-plane fault injectors (poison request, cache
                thrash, compile storm, latency spike) and the soak
                (repro_torch.serve)
"""
from .faults import (force_cap_overflow, nan_coefficients, poison_input,
                     truncate_interaction_lists)
from .serve_faults import (cache_thrash, compile_storm, latency_spike,
                           poison_request)

__all__ = [
    "force_cap_overflow", "nan_coefficients", "poison_input",
    "truncate_interaction_lists",
    "cache_thrash", "compile_storm", "latency_spike", "poison_request",
]
