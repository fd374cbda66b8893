"""The K-density level-fused M2L kernel's (``m2l_block_kernel``) share
(%) of its roofline over the traced block matvecs
(``_work_block.m2l_block``: an entry's scalings once, its H product K
times), from its device time in the trace."""
from ._work_block import block_roofline, m2l_block


def read(run, scope):
    return block_roofline(run, "m2l_block_kernel", m2l_block)
