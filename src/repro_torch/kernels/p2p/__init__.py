from .ops import p2p_apply, p2p_operands
from .p2p import p2p_cuda, p2p_plain

__all__ = ["p2p_apply", "p2p_operands", "p2p_cuda", "p2p_plain"]
