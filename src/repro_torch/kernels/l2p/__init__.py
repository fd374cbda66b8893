from .l2p import l2p_cuda, l2p_plain
from .ops import l2p_apply, l2p_operands

__all__ = ["l2p_cuda", "l2p_plain", "l2p_apply", "l2p_operands"]
