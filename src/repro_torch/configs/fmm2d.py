"""fmm2d — the paper's own configuration: adaptive 2D FMM potential
evaluation (Goude & Engblom 2012).

Shapes are particle counts; tree depth follows the paper's calibration
eq. (5.2) with N_d = 45 (their GPU optimum). p = 17 -> TOL ~ 1e-6 (5.3).
The same numbers as ``repro.configs.fmm2d``.
"""
from ..core.config import FmmConfig, num_levels_for

N_D = 45          # particles per leaf box (paper Fig. 5.2, GPU optimum)
P_TERMS = 17      # expansion terms   (paper: tolerance ~1e-6)


def fmm_config(n: int, *, p: int = P_TERMS, dtype: str = "f32",
               nlevels: int | None = None) -> FmmConfig:
    lv = num_levels_for(n, N_D) if nlevels is None else nlevels
    return FmmConfig(n=n, nlevels=lv, p=p, theta=0.5, kernel="harmonic",
                     dtype=dtype, strong_cap=48, weak_cap=128)


SMOKE = fmm_config(4096, p=8, nlevels=3)
