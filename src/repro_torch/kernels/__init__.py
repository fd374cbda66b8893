"""Hand-written CUDA kernels of the FMM (``csrc/*.cu``, built for
``sm_90a`` at first use) and their plain torch versions:

  topology/  strong/weak/swapped-theta classification and compaction of
             one topology level a launch
  m2l/       multipole-to-local translation, level-fused (main path) or
             one level per launch (per-phase path)
  eval/      fused evaluation phase (L2P + P2P + M2P) and the downward P2L
  l2p/       local-expansion evaluation at the particles (per-phase path)
  p2p/       near-field direct sum over the leaf lists (per-phase path)
  nbody/     direct all-pairs sum, the O(N^2) baseline (``nbody_direct``)
  upward/    the whole upward pass (P2M and every M2M level), at most
             two launches

Each wrapper launches its kernel for CUDA tensors and runs its plain
version for CPU tensors; ``build.launch_counts()`` reports how many
times each kernel was launched.
"""
from . import common
from .build import build_all, launch_counts, reset_launch_counts
from .eval import (eval_fused_apply, eval_fused_cuda, eval_fused_plain,
                   eval_operands, p2l_apply, p2l_cuda, p2l_operands,
                   p2l_plain)
from .l2p import l2p_apply, l2p_cuda, l2p_operands, l2p_plain
from .m2l import (fused_levels, m2l_cuda, m2l_fused_apply, m2l_level_apply,
                  m2l_operands, m2l_plain)
from .nbody import nbody_cuda, nbody_direct, nbody_plain, nbody_plan
from .p2p import p2p_apply, p2p_cuda, p2p_operands, p2p_plain
from .topology import level_classify_cuda, level_classify_plain
from .upward import upward_cuda, upward_launches, upward_plain

__all__ = [
    "common", "build_all", "launch_counts", "reset_launch_counts",
    "eval_fused_apply", "eval_fused_cuda", "eval_fused_plain",
    "eval_operands", "p2l_apply", "p2l_cuda", "p2l_operands", "p2l_plain",
    "l2p_apply", "l2p_cuda", "l2p_operands", "l2p_plain",
    "fused_levels", "m2l_cuda", "m2l_fused_apply", "m2l_level_apply",
    "m2l_operands", "m2l_plain",
    "nbody_cuda", "nbody_direct", "nbody_plain", "nbody_plan",
    "p2p_apply", "p2p_cuda", "p2p_operands", "p2p_plain",
    "level_classify_cuda", "level_classify_plain",
    "upward_cuda", "upward_launches", "upward_plain",
]
