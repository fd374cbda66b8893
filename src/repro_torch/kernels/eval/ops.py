"""Wiring of the fused evaluation and P2L kernels into the FMM.

``eval_fused_apply`` is the ``eval_fused_impl`` hook: it builds the dense
leaf planes once, issues exactly ONE kernel launch for the whole
evaluation phase of B problems and puts the result back in rank order.
``p2l_apply`` is the ``p2l_impl`` hook of the downward pass: one launch
over the (B, 4**L, p+1) local-coefficient blocks.

On the card the planes carry no TPU lane padding: P = p + 1 and the
particle planes are n_max wide.
"""
from __future__ import annotations

import torch

from ...core.config import FmmConfig
from ..common import (dense_leaf_arrays, dense_rank_planes, leaf_frames,
                      real_planes, scatter_from_leaves)
from .fused import eval_fused_cuda
from .p2l import p2l_cuda


def eval_operands(local, mult_leaf, tree, conn, cfg: FmmConfig):
    """Stage the fused evaluation kernel's operands: dense leaf particle
    planes, rank planes, pre-centered normalized targets, local and
    multipole coefficient planes. Returns (positional args, keyword
    args) of ``eval_fused_cuda``."""
    rdt = cfg.torch_real
    zr, zi, qr, qi = dense_leaf_arrays(tree.z, tree.q, cfg)
    rk = dense_rank_planes(cfg, zr.device)
    cr, ci, rh, tr, ti = leaf_frames(tree, cfg, zr, zi)
    br, bi = real_planes(local, rdt)
    kwargs = dict(p=cfg.p, kernel=cfg.kernel)
    m2p_lists = None
    if cfg.use_p2l_m2p:
        m2p_lists = conn.m2p.contiguous()
        ar, ai = real_planes(mult_leaf, rdt)
        kwargs.update(ar=ar, ai=ai, mcr=cr, mci=ci, mrho=rh)
    args = (conn.p2p.contiguous(), m2p_lists, zr, zi, qr, qi, rk, tr, ti,
            br, bi)
    return args, kwargs


def eval_fused_apply(local, mult_leaf, tree, conn, cfg: FmmConfig):
    """Drop-in ``eval_fused_impl`` for ``core.fmm.fmm_evaluate``.

    local / mult_leaf: (B, nbox, p+1) leaf local expansions and
    multipoles. Returns the (B, n) evaluation-phase potential (L2P + M2P
    + P2P) in rank order, from ONE kernel launch.
    """
    args, kwargs = eval_operands(local, mult_leaf, tree, conn, cfg)
    outr, outi = eval_fused_cuda(*args, **kwargs)
    return scatter_from_leaves(torch.complex(outr, outi), cfg)


def p2l_operands(tree, conn, cfg: FmmConfig, rho):
    """Stage the P2L kernel's operands: (positional args, keyword args)
    of ``p2l_cuda``."""
    rdt = cfg.torch_real
    zr, zi, qr, qi = dense_leaf_arrays(tree.z, tree.q, cfg)
    cr, ci = real_planes(tree.centers[cfg.nlevels], rdt)
    args = (conn.p2l.contiguous(), cr, ci, rho.to(rdt).contiguous(), zr, zi,
            qr, qi)
    return args, dict(p=cfg.p, kernel=cfg.kernel)


def p2l_apply(tree, conn, cfg: FmmConfig, rho):
    """Drop-in ``p2l_impl`` for the downward pass: the (B, nbox, p+1)
    radius-normalized P2L contribution (added to ``local`` by the
    caller), from ONE kernel launch."""
    args, kwargs = p2l_operands(tree, conn, cfg, rho)
    outr, outi = p2l_cuda(*args, **kwargs)
    return torch.complex(outr, outi).to(cfg.torch_complex)
