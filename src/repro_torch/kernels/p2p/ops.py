"""Wiring of the P2P kernel into the FMM evaluation phase.

``p2p_apply`` is the ``p2p_impl`` hook of ``core.fmm.fmm_evaluate`` (the
per-phase path, taken when no fused evaluation hook is set): it stages
the dense leaf planes, issues ONE kernel launch for the near field of B
problems and puts the result back in rank order.
"""
from __future__ import annotations

import torch

from ...core.config import FmmConfig
from ..common import dense_leaf_arrays, dense_rank_planes, scatter_from_leaves
from .p2p import p2p_cuda


def p2p_operands(tree, conn, cfg: FmmConfig):
    """Stage the P2P kernel's operands: (positional args, keyword args)
    of ``p2p_cuda``."""
    zr, zi, qr, qi = dense_leaf_arrays(tree.z, tree.q, cfg)
    rk = dense_rank_planes(cfg, zr.device)
    return (conn.p2p.contiguous(), zr, zi, qr, qi, rk), dict(kernel=cfg.kernel)


def p2p_apply(tree, conn, cfg: FmmConfig):
    """Drop-in ``p2p_impl``: the (B, n) near-field potential in rank order
    (added to phi by the caller), from ONE kernel launch."""
    args, kwargs = p2p_operands(tree, conn, cfg)
    outr, outi = p2p_cuda(*args, **kwargs)
    return scatter_from_leaves(torch.complex(outr, outi), cfg)
