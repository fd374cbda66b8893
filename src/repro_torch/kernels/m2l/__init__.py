from .m2l import m2l_cuda, m2l_plain
from .ops import (fused_levels, m2l_fused_apply, m2l_level_apply,
                  m2l_operands)

__all__ = ["m2l_cuda", "m2l_plain", "fused_levels", "m2l_fused_apply",
           "m2l_level_apply", "m2l_operands"]
