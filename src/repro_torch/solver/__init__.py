"""FMM solver front-end: plan caching by (config, backend, device),
backend dispatch per phase, batched multi-problem evaluation, and the
topology/evaluation seam of time-stepping callers.

    from repro_torch.solver import FmmSolver
    solver = FmmSolver.build(cfg)            # the CUDA card by default
    phi = solver.apply(z, q)
    phib = solver.apply_batched(zb, qb)
    plan = solver.refresh(z, q)              # topology only
    phi = solver.apply_plan(plan)            # evaluation only
"""
from .backends import (BATCHED_DISPATCH, Backend, available_backends,
                       get_backend, register_backend)
from ..device import resolve_device
from .solver import CacheInfo, FmmSolver, host_health, raise_unhealthy

__all__ = [
    "FmmSolver", "CacheInfo", "host_health", "raise_unhealthy",
    "resolve_device", "Backend", "BATCHED_DISPATCH", "available_backends",
    "get_backend", "register_backend",
]
