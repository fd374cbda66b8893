"""The fused evaluation kernel's (L2P + P2P + M2P) share (%) of its
roofline in its log branch over the traced matvecs
(``_work_log.eval_fused_log``), from its device time in the trace."""
from ._work import roofline
from ._work_log import eval_fused_log


def read(run, scope):
    return roofline(run, "eval_fused_kernel", eval_fused_log)
