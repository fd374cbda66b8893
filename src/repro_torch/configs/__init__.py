"""Problem configurations: ``fmm2d`` is the paper's own (calibrated tree
depth, expansion order and caps for 2D adaptive potential evaluation)."""
from .fmm2d import N_D, P_TERMS, SMOKE, fmm_config

__all__ = ["N_D", "P_TERMS", "SMOKE", "fmm_config"]
