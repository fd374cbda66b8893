"""Ragged-traffic serving plane, the twin of ``repro.serve``.

Routes heterogeneous (z, q) request streams onto the batched main path
on one device: shape bucketing with exact zero-charge padding, a keyed
guarded-solver cache with warm-up and per-bucket counters, and an
admission + degradation controller that turns every typed fault into
either a recovery or a typed rejection in a structured ``ServeReport``.

    from repro_torch.serve import Request, ServePlane
    plane = ServePlane()                      # the CUDA card
    results = plane.serve([Request(z1, q1), Request(z2, q2)])
"""
from .buckets import BucketLattice, pad_problem, unpad
from .cache import BucketCacheStats, PlanCache, default_cfg_factory
from .plane import (Request, ServePlane, ServeReport, ServeResult,
                    STATUSES)

__all__ = [
    "BucketLattice",
    "pad_problem",
    "unpad",
    "BucketCacheStats",
    "PlanCache",
    "default_cfg_factory",
    "Request",
    "ServePlane",
    "ServeReport",
    "ServeResult",
    "STATUSES",
]
