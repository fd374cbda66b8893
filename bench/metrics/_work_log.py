"""Operations and bytes of the fused evaluation kernel's log branch
(G = q log(z - x)), for its roofline share.

Operations are counted as the plain formula computes each term, each
log and each atan2 one operation: a near-field pair is d = x - z (2),
log d = (log(dx^2 + dy^2) / 2, atan2(dy, dx)) (6), q log d (6) and the
accumulation (2): 16 operations, where ``_work.eval_fused`` counts the
harmonic pair's 14; an M2P target adds to the harmonic's Horner terms
a_0 log(z - z0) (the log 6, the product 6, the sum 2): 14 more. This is
a stated lower bound on the work, independent of how the kernel computes
a log or an atan2 (a polynomial of tens of operations on the card). The
L2P terms and every byte are the harmonic kernel's: the two branches
read and write the same operands. ``work`` is as ``_work`` takes it.
"""
from __future__ import annotations

from ._work import _leaf_width, eval_fused

#: Operations a near-field pair adds over the harmonic pair's count.
PAIR_EXTRA = 16 - 14
#: Operations of the a_0 log(z - z0) term of one M2P target.
M2P_LOG = 14


def eval_fused_log(work: dict, batch: int = 1) -> tuple[float, float, float]:
    """(operations, of them dense, bytes) of one fused evaluation launch
    of the log kernel."""
    flops, dense, nbytes = eval_fused(work, batch)
    n = _leaf_width(work)
    flops += work["p2p"] * n * n * PAIR_EXTRA
    if work["m2p_lists"]:
        flops += work["m2p"] * n * M2P_LOG
    return float(flops), dense, nbytes
