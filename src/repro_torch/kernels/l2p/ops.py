"""Wiring of the L2P kernel into the FMM evaluation phase.

``l2p_apply`` is the ``l2p_impl`` hook of ``core.fmm.fmm_evaluate`` (the
per-phase path): it stages the pre-centered, radius-normalized particle
planes and the (p+1)-term coefficient planes as ``eval_operands`` does,
issues ONE kernel launch for B problems and puts the result back in rank
order.
"""
from __future__ import annotations

import torch

from ...core.config import FmmConfig
from ..common import (dense_leaf_arrays, dense_rank_planes, leaf_frames,
                      real_planes, scatter_from_leaves)
from .l2p import l2p_cuda


def l2p_operands(local, tree, cfg: FmmConfig):
    """Stage the L2P kernel's operands: (positional args, keyword args)
    of ``l2p_cuda``."""
    zr, zi, _, _ = dense_leaf_arrays(tree.z, tree.q, cfg)
    *_, tr, ti = leaf_frames(tree, cfg, zr, zi)
    br, bi = real_planes(local, cfg.torch_real)
    rk = dense_rank_planes(cfg, zr.device)
    return (br, bi, tr, ti, rk), dict(p=cfg.p)


def l2p_apply(local, tree, cfg: FmmConfig):
    """Drop-in ``l2p_impl``: the (B, nbox, p+1) leaf local expansions
    evaluated at the particles, (B, n) in rank order, from ONE kernel
    launch."""
    args, kwargs = l2p_operands(local, tree, cfg)
    outr, outi = l2p_cuda(*args, **kwargs)
    return scatter_from_leaves(torch.complex(outr, outi), cfg)
