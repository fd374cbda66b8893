"""Shared helpers around the CUDA kernels.

Kernels take separate real/imaginary planes and *dense per-leaf* particle
planes of shape (B, 4**L, n_max): leaf b's particles in rank order,
zero-charge padding in the unused slots. Unlike the TPU layout there is
no trailing all-zero dummy row and no 128-lane padding: a kernel skips a
masked (-1) list entry instead of reading a dummy row, and planes are
exactly n_max = max leaf population wide (64 at the paper's N = 2^20).

``pairwise_tile`` and ``l2p_horner`` are the plain torch forms of the
kernels' per-target math (the twins of ``repro.kernels.common``'s);
``p2p_slots`` is the plain form of the near-field loop that the P2P and
fused evaluation kernels share.

K densities on one geometry (``core.fmm``'s density axis): the charge,
coefficient and result planes carry K rows where the positions, lists,
centres and radii keep one. The plain versions broadcast the single
rows; the CUDA wrappers launch the K-density kernels
(``geometry_rows``, ``density_chunks``).
"""
from __future__ import annotations

import torch

from ..core.config import FmmConfig
from ..core.fmm import effective_radii, from_leaves, leaf_planes, rows
from ..core.topology import leaf_layout


#: Densities a launch of a K-density kernel (``*_block`` entry points of
#: the fused evaluation and M2L) evaluates: its template instantiation.
BLOCK_KD = 8


def density_chunks(K: int) -> list[tuple[int, int]]:
    """(first row, densities) of each launch that evaluates K densities:
    blocks of BLOCK_KD on the K-density kernel, then each remaining
    density on the single-density kernel (K = 3 runs as 1 + 1 + 1,
    K = 11 as 8 + 1 + 1 + 1, K = 16 as 8 + 8)."""
    full = K - K % BLOCK_KD
    return ([(k0, BLOCK_KD) for k0 in range(0, full, BLOCK_KD)]
            + [(k0, 1) for k0 in range(full, K)])


def geometry_rows(geometry: torch.Tensor, charges: torch.Tensor) -> bool:
    """Whether ``charges`` carry K densities on the single geometry of
    ``geometry`` (leading axes 1 and K > 1) rather than one row a problem
    (equal leading axes); anything else raises."""
    G, K = geometry.shape[0], charges.shape[0]
    if K == G:
        return False
    if G != 1:
        raise ValueError(f"{K} charge rows on {G} problems: densities need "
                         "a one-problem plan")
    return True


def dense_leaf_arrays(z: torch.Tensor, q: torch.Tensor, cfg: FmmConfig):
    """Gather (B, N) rank-sorted particles into (B, 4**L, n_max) real
    planes (zr, zi, qr, qi) of the config's dtype; padded slots hold
    z = 0 and q = 0."""
    rdt = cfg.torch_real
    zl = leaf_planes(z, cfg)
    ql = leaf_planes(q, cfg)
    return tuple(x.to(rdt).contiguous()
                 for x in (zl.real, zl.imag, ql.real, ql.imag))


def dense_rank_planes(cfg: FmmConfig, device) -> torch.Tensor:
    """(4**L, n_max) int32 global particle ranks per dense leaf slot, -1
    in padded slots — the plane the kernels compare to exclude
    self-interaction by particle identity, not by position."""
    return leaf_layout(cfg.n, cfg.nlevels, device).ranks


def real_planes(x: torch.Tensor, rdt):
    """Complex tensor -> contiguous (real, imag) planes of dtype ``rdt``."""
    return x.real.to(rdt).contiguous(), x.imag.to(rdt).contiguous()


def leaf_frames(tree, cfg: FmmConfig, zr, zi):
    """The leaf boxes' centers and effective radii as real planes, and the
    particles pre-centered and radius-normalized, t = (z - z0)/rho:
    (cr, ci, rh) of shape (B, 4**L) and (tr, ti) like ``zr``."""
    rdt = cfg.torch_real
    L = cfg.nlevels
    cr, ci = real_planes(tree.centers[L], rdt)
    rh = effective_radii(tree, cfg)[L].to(rdt).contiguous()
    tr = ((zr - cr[..., None]) / rh[..., None]).contiguous()
    ti = ((zi - ci[..., None]) / rh[..., None]).contiguous()
    return cr, ci, rh, tr, ti


def scatter_from_leaves(values: torch.Tensor, cfg: FmmConfig) -> torch.Tensor:
    """(B, 4**L, n_max) dense leaf planes -> (B, N) rank order (each rank
    owns one slot, so this is a gather: no atomics, deterministic on
    CUDA)."""
    return from_leaves(values, cfg)


def pairwise_tile(kernel: str, tzr, tzi, trk, szr, szi, qr, qi, srk):
    """One source tile against the targets: (..., n_t) targets and
    (..., n_s) sources -> the (..., n_t) (real, imag) contribution,
    excluding pairs of equal rank and padded (rank -1) sources."""
    dx = szr[..., None, :] - tzr[..., :, None]     # z_src - z_tgt
    dy = szi[..., None, :] - tzi[..., :, None]
    qr, qi = qr[..., None, :], qi[..., None, :]
    d2 = dx * dx + dy * dy
    ok = (srk[..., None, :] >= 0) & (srk[..., None, :] != trk[..., :, None])
    zero = torch.zeros((), dtype=d2.dtype, device=d2.device)
    if kernel == "harmonic":
        inv = torch.where(ok, 1.0 / torch.where(ok, d2, zero + 1), zero)
        return (((qr * dx + qi * dy) * inv).sum(dim=-1),
                ((qi * dx - qr * dy) * inv).sum(dim=-1))
    lr = torch.where(ok, 0.5 * torch.log(torch.where(ok, d2, zero + 1)), zero)
    li = torch.where(ok, torch.atan2(-dy, -dx), zero)
    return ((qr * lr - qi * li).sum(dim=-1), (qr * li + qi * lr).sum(dim=-1))


def p2p_slots(accr, acci, lists, zr, zi, qr, qi, rk, kernel: str):
    """Add the near field over the (B, nb, S) P2P lists to the (B, nb, n)
    accumulators, one list slot at a time: targets and sources are the
    same dense leaf planes, ``rk`` their (nb, n) rank plane."""
    zero = torch.zeros((), dtype=zr.dtype, device=zr.device)
    trk = rk.long()
    for s in range(lists.shape[-1]):
        src = lists[..., s].long()
        valid = (src >= 0)[..., None]
        srcc = torch.where(src >= 0, src, torch.zeros_like(src))
        sr, si = pairwise_tile(kernel, zr, zi, trk, rows(zr, srcc),
                               rows(zi, srcc), rows(qr, srcc),
                               rows(qi, srcc), trk[srcc])
        accr = accr + torch.where(valid, sr, zero)
        acci = acci + torch.where(valid, si, zero)
    return accr, acci


def l2p_horner(p: int, br, bi, tr, ti):
    """Local-expansion Horner at pre-centered particles: (..., P)
    coefficient planes and (..., n) positions -> (..., n) (real, imag)."""
    accr = torch.zeros_like(tr) + br[..., p:p + 1]
    acci = torch.zeros_like(ti) + bi[..., p:p + 1]
    for j in range(p - 1, -1, -1):
        accr, acci = (accr * tr - acci * ti + br[..., j:j + 1],
                      accr * ti + acci * tr + bi[..., j:j + 1])
    return accr, acci
