"""The direct N-body entry point: the FMM's O(N^2) baseline (paper Figs
5.5/5.6) through the all-pairs kernel."""
from __future__ import annotations

import torch

from .nbody import nbody_cuda


def nbody_direct(z_eval: torch.Tensor, z_src: torch.Tensor,
                 q: torch.Tensor) -> torch.Tensor:
    """Phi(y_i) = sum_{x_j != y_i} q_j/(x_j - y_i) (harmonic G); returns
    the (len(z_eval),) complex potential, in the real dtype of ``z_src``,
    from ONE kernel launch on a CUDA device (the plain version on the
    CPU). Coincident positions are excluded, as in ``direct_potential``.
    The kernel needs no padding, so no padded (q = 0) source exists."""
    cdt = z_src.dtype
    z_eval, q = z_eval.to(cdt), q.to(cdt)

    def planes(x):
        return x.real.contiguous(), x.imag.contiguous()

    outr, outi = nbody_cuda(*planes(z_eval), *planes(z_src), *planes(q))
    return torch.complex(outr, outi)
