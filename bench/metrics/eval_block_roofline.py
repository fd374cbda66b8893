"""The K-density fused evaluation kernel's (``eval_block_kernel``) share
(%) of its roofline over the traced block matvecs
(``_work_block.eval_block``: a pair's geometry and logarithm once, each
density's term K times), from its device time in the trace."""
from ._work_block import block_roofline, eval_block


def read(run, scope):
    return block_roofline(run, "eval_block_kernel", eval_block)
