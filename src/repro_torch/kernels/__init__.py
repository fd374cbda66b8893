"""Hand-written CUDA kernels for the FMM main path (``csrc/*.cu``, built
for ``sm_90a`` at first use) and their plain torch versions:

  topology/  leaf-level strong/weak/swapped-theta classification
  m2l/       level-fused multipole-to-local translation
  eval/      fused evaluation phase (L2P + P2P + M2P) and the downward P2L

Each wrapper launches its kernel for CUDA tensors and runs its plain
version for CPU tensors; ``build.launch_counts()`` reports how many
times each kernel was launched.
"""
from . import common
from .build import build_all, launch_counts, reset_launch_counts
from .eval import (eval_fused_apply, eval_fused_cuda, eval_fused_plain,
                   eval_operands, p2l_apply, p2l_cuda, p2l_operands,
                   p2l_plain)
from .m2l import (fused_levels, m2l_cuda, m2l_fused_apply, m2l_operands,
                  m2l_plain)
from .topology import leaf_classify_cuda, leaf_classify_plain

__all__ = [
    "common", "build_all", "launch_counts", "reset_launch_counts",
    "eval_fused_apply", "eval_fused_cuda", "eval_fused_plain",
    "eval_operands", "p2l_apply", "p2l_cuda", "p2l_operands", "p2l_plain",
    "fused_levels", "m2l_cuda", "m2l_fused_apply", "m2l_operands",
    "m2l_plain",
    "leaf_classify_cuda", "leaf_classify_plain",
]
