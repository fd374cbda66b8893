"""The level-fused M2L kernel's share (%) of its roofline over the traced
solves (``_work.m2l``), from its device time in the trace."""
from ._work import m2l, roofline


def read(run, scope):
    return roofline(run, "m2l_kernel", m2l)
