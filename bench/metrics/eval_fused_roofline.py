"""The fused evaluation kernel's (L2P + P2P + M2P) share (%) of its
roofline over the traced solves (``_work.eval_fused``), from its device
time in the trace."""
from ._work import eval_fused, roofline


def read(run, scope):
    return roofline(run, "eval_fused_kernel", eval_fused)
