"""FMM solver front-end: plan caching by (config, backend, device),
backend dispatch per phase, batched multi-problem evaluation, the
topology/evaluation seam of time-stepping callers, cap autotuning and
the guarded recovery ladder.

    from repro_torch.solver import FmmSolver
    solver = FmmSolver.build(cfg)            # the CUDA card by default
    phi = solver.apply(z, q)
    phib = solver.apply_batched(zb, qb)
    plan = solver.refresh(z, q)              # topology only
    phi = solver.apply_plan(plan)            # evaluation only
    solver._compiled_program_count()         # programs held (one per
    solver._release_executables()            # entry point and shape)
    solver = solver.tune(z_sample)           # fit the list caps
    phi, report = solver.guarded().apply_guarded(z, q)
"""
from .autotune import TuneResult, probe_caps, tune_caps, tune_tiles
from .backends import (BATCHED_DISPATCH, Backend, available_backends,
                       get_backend, register_backend)
from ..device import resolve_device
from .guard import GuardAttempt, GuardedSolver, GuardReport
from .program import (Program, program_budget, program_memory,
                      set_program_budget)
from .solver import CacheInfo, FmmSolver, host_health, raise_unhealthy

__all__ = [
    "FmmSolver", "CacheInfo", "host_health", "raise_unhealthy",
    "GuardedSolver", "GuardReport", "GuardAttempt",
    "resolve_device", "Backend", "BATCHED_DISPATCH", "available_backends",
    "get_backend", "register_backend",
    "TuneResult", "probe_caps", "tune_caps", "tune_tiles",
    "Program", "program_budget", "program_memory", "set_program_budget",
]
