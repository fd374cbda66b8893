"""Adaptive fast multipole method (Goude & Engblom 2012) in PyTorch.

Public API:
  FmmConfig, num_levels_for        — problem description / calibration
  build_tree, build_connectivity   — topological phase
  fmm_build, fmm_evaluate          — the pipeline, with its kernel hooks
  fmm_potential                    — end-to-end evaluation (plain sweeps),
                                     ``_checked``/``_with_stats`` variants
  direct_potential                 — O(N^2) oracle (numpy twin beside it)
"""
from .config import FmmConfig, max_leaf_size, num_levels_for
from .topology import (MARGIN_CLASSES, Connectivity, Tree,
                       build_connectivity, build_tree, connectivity_stats,
                       leaf_ids, leaf_particle_index)
from .fmm import (HEALTH_CLASSES, FmmPlan, Health, downward, fmm_build,
                  fmm_evaluate, fmm_potential, fmm_potential_checked,
                  fmm_potential_with_stats, health_of, l2p, p2m,
                  plan_from_numpy, upward)
from .direct import direct_potential, direct_potential_numpy, rel_error_inf

__all__ = [
    "FmmConfig", "num_levels_for", "max_leaf_size",
    "Tree", "build_tree", "leaf_particle_index", "leaf_ids",
    "Connectivity", "MARGIN_CLASSES", "build_connectivity",
    "connectivity_stats",
    "FmmPlan", "Health", "HEALTH_CLASSES", "fmm_build", "fmm_evaluate",
    "fmm_potential", "fmm_potential_checked", "fmm_potential_with_stats",
    "health_of", "p2m", "upward", "downward", "l2p",
    "plan_from_numpy", "direct_potential", "direct_potential_numpy",
    "rel_error_inf",
]
