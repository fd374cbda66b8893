from .fused import eval_fused_cuda, eval_fused_plain
from .ops import eval_fused_apply, eval_operands, p2l_apply, p2l_operands
from .p2l import p2l_cuda, p2l_plain

__all__ = ["eval_fused_cuda", "eval_fused_plain", "eval_fused_apply",
           "eval_operands", "p2l_apply", "p2l_operands", "p2l_cuda", "p2l_plain"]
