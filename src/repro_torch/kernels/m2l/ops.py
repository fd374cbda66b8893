"""Wiring of the M2L kernel into the FMM downward pass. Two entry points
share one kernel and one operand staging (``m2l_planes``):

``m2l_fused_apply`` is the ``m2l_fused_impl`` hook: it flattens *all*
levels of the downward pass into one (B, sum 4^l, W) box axis with static
per-level offsets and issues exactly one kernel launch for the whole
downward M2L of B problems. ``m2l_level_apply`` is the per-level
``m2l_impl`` hook of ``core.fmm.fmm_evaluate``: one launch per level.
Either way ``fmm_evaluate`` folds the per-level contributions into the
leaf locals with one L2L loop.
"""
from __future__ import annotations

import numpy as np
import torch

from ...core.config import FmmConfig
from ...core.fmm import m2l_mat
from .m2l import m2l_cuda


def fused_levels(cfg: FmmConfig) -> list[int]:
    """Levels the fused downward M2L covers (1..L; just the root if L=0)."""
    return list(range(1, cfg.nlevels + 1)) if cfg.nlevels > 0 else [0]


def hankel(cfg: FmmConfig, device) -> torch.Tensor:
    """The (p+1, p+1) constant M2L matrix in the config's real dtype
    (built once per p, dtype and device)."""
    return m2l_mat(cfg.p, cfg.torch_real, torch.device(device))


def m2l_planes(mult, weak, centers, cfg: FmmConfig, rho):
    """The kernel operands over one flat box axis, from (B, NB, p+1)
    multipoles, (B, NB, W) weak lists into that axis and (B, NB) centers
    and radii: the operands of ``m2l_cuda`` (the kernel computes each
    slot's ratios itself)."""
    rdt = cfg.torch_real

    def plane(x):
        return x.to(rdt).contiguous()

    return (weak.contiguous(), plane(mult.real), plane(mult.imag),
            plane(centers.real), plane(centers.imag), plane(rho),
            hankel(cfg, weak.device), cfg.kernel)


def m2l_operands(mult, weak, centers, cfg: FmmConfig, rho):
    """Stage the kernel operands of the fused M2L from the per-level
    sequences (index = level, each with a leading B axis): every level's
    boxes concatenated into one flat axis — the weak lists are
    level-local, so each level's entries shift by its static offset —
    then ``m2l_planes``. Returns (operands of ``m2l_cuda``, level
    offsets)."""
    levels = fused_levels(cfg)
    offs = np.concatenate([[0], np.cumsum([4**l for l in levels])])
    weak_flat = torch.cat(
        [torch.where(weak[l] >= 0, weak[l] + int(offs[i]),
                     torch.full_like(weak[l], -1))
         for i, l in enumerate(levels)], dim=1)
    mult_flat = torch.cat([mult[l] for l in levels], dim=1)
    c = torch.cat([centers[l] for l in levels], dim=1)
    rh = torch.cat([rho[l] for l in levels], dim=1)
    return m2l_planes(mult_flat, weak_flat, c, cfg, rh), offs


def m2l_level_apply(mult, weak, centers, cfg: FmmConfig, rho):
    """Drop-in ``m2l_impl`` for ``core.fmm.fmm_evaluate``: the M2L of
    one level's (B, 4**l) boxes, ONE kernel launch. Returns the (B, 4**l,
    p+1) normalized local contributions."""
    outr, outi = m2l_cuda(*m2l_planes(mult, weak, centers, cfg, rho))
    return torch.complex(outr, outi).to(cfg.torch_complex)


def m2l_fused_apply(mult, weak, centers, cfg: FmmConfig, rho):
    """Drop-in ``m2l_fused_impl`` for ``core.fmm.fmm_evaluate``: ONE
    kernel launch for the whole downward M2L of B problems. Returns the
    per-level (B, 4**l, p+1) normalized local contributions."""
    args, offs = m2l_operands(mult, weak, centers, cfg, rho)
    outr, outi = m2l_cuda(*args)
    out = torch.complex(outr, outi).to(cfg.torch_complex)
    return [out[:, int(offs[i]):int(offs[i + 1])]
            for i in range(len(offs) - 1)]
