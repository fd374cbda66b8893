"""FMM solver front-end: plan caching by (config, backend, device),
backend dispatch per phase, batched multi-problem evaluation.

    from repro_torch.solver import FmmSolver
    solver = FmmSolver.build(cfg)            # the CUDA card by default
    phi = solver.apply(z, q)
    phib = solver.apply_batched(zb, qb)
"""
from .backends import (Backend, available_backends, get_backend,
                       register_backend)
from ..device import resolve_device
from .solver import FmmSolver, host_health, raise_unhealthy

__all__ = [
    "FmmSolver", "host_health", "raise_unhealthy",
    "resolve_device", "Backend", "available_backends", "get_backend",
    "register_backend",
]
