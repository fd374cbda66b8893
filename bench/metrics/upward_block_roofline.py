"""The K-density upward pass's (``upward_block_kernel``, two launches a
call at seven levels) share (%) of its roofline over the traced block
matvecs (``_work_block.upward_block``), from its device time in the
trace."""
from ._work_block import block_roofline, upward_block


def read(run, scope):
    return block_roofline(run, "upward_block_kernel", upward_block,
                          launches=2)
