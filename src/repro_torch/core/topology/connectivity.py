"""Theta-criterion connectivity (paper §2, eq. (2.1)) — batched build.

Per level l, every box carries a *directed* strong list and a *directed*
weak (M2L) list, padded to static caps: symmetric pairs are duplicated so
each box's interactions are computed independently, without atomics.

Candidates for box b at level l are exactly the children of the strong set
of b's parent; each candidate is classified by

    well-separated(b, c)  <=>  R + theta*r <= theta*d,
    R = max(r_b, r_c), r = min(r_b, r_c), d = |z_b - z_c|.

At the leaf level, strong pairs are re-tested with r/R roles swapped
(Carrier-Greengard, paper §2): passing pairs become P2L (the larger box's
particles shift directly into the smaller box's local expansion) / M2P
(the smaller box's multipole is evaluated at the larger box's points)
instead of P2P.

One build, level by level: ``build_connectivity`` calls the backend's
topology hook (``leaf_classify_impl``; ``repro_torch.kernels.topology``
holds the CUDA kernel, one launch a level on the card) or, without one,
``classify_level_reference``, the hook's contract in plain torch, once
a level, l = 1..L in order. Each call returns the level's lists already
compacted and each row's count of every class. No sort: a box's
candidates are the children ``4p + k`` of its parent's strong entries
``p`` in list order; the root's list is ``[0]`` and each compacted list
keeps candidate order, so every list ascends and a stable compaction of
a row equals the sorted row, clipped at the cap to the same entries.
One reduction of the counts gives the margins. With no level below the
root, the root's own strong list takes the swapped test alone.

The predicates use ``rounding.hypot_xla``/``rounding.fma_rn`` so the lists
are bit-identical to ``repro.core.topology.build_connectivity`` (the
reference contracts ``big + theta*small`` into one fused multiply-add).
All tensors carry a leading problem axis B; ``margins`` is (B, 5) and
``overflow`` (B,). The counters ``connectivity.kernel_levels`` and
``connectivity.plain_levels`` add the levels each build (eager or
captured) classified by the kernel and in plain torch.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ... import trace
from ..config import FmmConfig
from .rounding import fma_rn, hypot_xla
from .tree import Tree

#: Order of the per-class cap-margin vector (``Connectivity.margins``).
MARGIN_CLASSES = ("strong", "weak", "p2p", "p2l", "m2p")


class Connectivity(NamedTuple):
    strong: tuple          # level l: (B, 4**l, strong_cap) int32, -1 pad
    weak: tuple            # level l: (B, 4**l, weak_cap)
    p2p: torch.Tensor      # leaf: (B, 4**L, strong_cap)
    p2l: torch.Tensor      # leaf: (B, 4**L, strong_cap)
    m2p: torch.Tensor      # leaf: (B, 4**L, strong_cap)
    overflow: torch.Tensor  # (B,) int32; 0 iff no list overflowed
    margins: torch.Tensor  # (B, 5) int32 per-class cap margins in
    #                        MARGIN_CLASSES order: slots left on the fullest
    #                        row (min over levels); negative = that many
    #                        entries were dropped.


def theta_masks(cbx, cby, rb, ccx, ccy, rc, valid, theta: float):
    """(weak_mask, strong_mask) on real coordinate planes; target planes
    (B, nb), candidate planes (B, nb, C)."""
    d = hypot_xla(cbx[..., None] - ccx, cby[..., None] - ccy)
    big = torch.maximum(rb[..., None], rc)
    small = torch.minimum(rb[..., None], rc)
    wellsep = fma_rn(theta, small, big) <= theta * d
    return valid & wellsep, valid & ~wellsep


def swapped_masks(cbx, cby, rb, ccx, ccy, rc, strong_mask, cfg: FmmConfig):
    """Leaf reclassification: (p2p, p2l, m2p) masks over the strong set."""
    if not cfg.use_p2l_m2p:
        zero = torch.zeros_like(strong_mask)
        return strong_mask, zero, zero
    d = hypot_xla(cbx[..., None] - ccx, cby[..., None] - ccy)
    big = torch.maximum(rb[..., None], rc)
    small = torch.minimum(rb[..., None], rc)
    swapped = fma_rn(cfg.theta, big, small) <= cfg.theta * d
    p2l = strong_mask & swapped & (rc > rb[..., None])     # source larger
    m2p = strong_mask & swapped & (rc < rb[..., None])     # source smaller
    p2p = strong_mask & ~(p2l | m2p)
    return p2p, p2l, m2p


def gather_geometry(cand, valid, centers, radii):
    """(ccx, ccy, rc) of the candidate boxes (B, nb, C), zero where
    invalid; ``centers``/``radii`` are the level's (B, nb) planes."""
    B, nb, C = cand.shape
    idx = torch.where(valid, cand, torch.zeros_like(cand)).long().view(B, -1)
    zero = torch.zeros((), dtype=radii.dtype, device=radii.device)

    def take(a):
        return torch.where(valid, torch.gather(a, -1, idx).view(B, nb, C),
                           zero)

    return (take(centers.real.contiguous()), take(centers.imag.contiguous()),
            take(radii))


def _candidates(parent_strong, nb: int):
    """(cand, valid) (B, nb, 4S) of a level: the children ``4p + k`` of
    each box's parent's strong entries ``p``, in list order."""
    B, _, S = parent_strong.shape
    dev = parent_strong.device
    parent = torch.arange(nb, device=dev) // 4
    ps = parent_strong[:, parent]                              # (B, nb, S)
    pvalid = ps >= 0
    four = torch.arange(4, dtype=torch.int32, device=dev)
    cand = (torch.where(pvalid, ps, torch.zeros_like(ps))[..., None] * 4
            + four).view(B, nb, 4 * S)
    valid = pvalid[..., None].expand(B, nb, S, 4).reshape(B, nb, 4 * S)
    return cand, valid


def _stream_compact(cand, mask, cap: int):
    """Row-compact masked entries to the front in candidate order, pad
    with -1, clip to cap: the kernel's compaction, with no sort."""
    pos = mask.cumsum(dim=-1) - 1
    slot = torch.where(mask & (pos < cap), pos, torch.full_like(pos, cap))
    out = torch.full(mask.shape[:-1] + (cap + 1,), -1, dtype=torch.int32,
                     device=mask.device)
    out.scatter_(-1, slot, cand)                  # slot cap: the dropped
    return out[..., :cap].contiguous()


def count_levels(kernel: int = 0, plain: int = 0) -> None:
    """Add a build's levels classified by the kernel and in plain torch
    to the counters ``connectivity.kernel_levels`` / ``.plain_levels``
    (both present after any build)."""
    trace.count("connectivity.kernel_levels", kernel)
    trace.count("connectivity.plain_levels", plain)


def classify_level_reference(parent_strong, centers, radii, cfg: FmmConfig,
                             leaf: bool):
    """One level of the topology hook in plain torch (the contract the
    CUDA kernel of ``repro_torch.kernels.topology`` keeps).

    ``parent_strong``: the parent level's compacted (B, 4**(l-1), S)
    strong lists; ``centers``/``radii``: level l's (B, 4**l) planes.
    Returns (lists, counts): the compacted (strong, weak) lists of level
    l, or at the leaf (strong, weak, p2p, p2l, m2p), each (B, 4**l, cap)
    int32 padded with -1, and the (B, 4**l, 5) int32 count of each class
    a row before clipping (``MARGIN_CLASSES`` order; the leaf classes 0
    above the leaf).
    """
    count_levels(plain=1)
    cand, valid = _candidates(parent_strong, radii.shape[1])
    cbx, cby = centers.real, centers.imag
    ccx, ccy, rc = gather_geometry(cand, valid, centers, radii)
    weak_m, strong_m = theta_masks(cbx, cby, radii, ccx, ccy, rc, valid,
                                   cfg.theta)
    masks = [strong_m, weak_m]
    if leaf:
        masks += swapped_masks(cbx, cby, radii, ccx, ccy, rc, strong_m, cfg)
    caps = (cfg.strong_cap, cfg.weak_cap) + 3 * (cfg.strong_cap,)
    lists = tuple(_stream_compact(cand, m, cap) for m, cap in zip(masks, caps))
    counts = [m.sum(dim=-1) for m in masks]
    counts += [torch.zeros_like(counts[0])] * (len(MARGIN_CLASSES) - len(masks))
    return lists, torch.stack(counts, dim=-1).to(torch.int32)


def _overflow_of(margins: torch.Tensor) -> torch.Tensor:
    """Dropped-entry count per problem implied by (B, 5) margins."""
    return (-torch.clamp(margins.amin(dim=-1), max=0)).to(torch.int32)


def build_connectivity(tree: Tree, cfg: FmmConfig,
                       leaf_classify_impl=None) -> Connectivity:
    """Interaction lists for every level of B problems.

    ``leaf_classify_impl(parent_strong, centers, radii, cfg, leaf)``, the
    backend's topology hook (module docstring), classifies and compacts
    each level l = 1..L (on the card, the CUDA kernel of
    ``repro_torch.kernels.topology``); ``None`` calls
    ``classify_level_reference``. The margins are the caps less the
    fullest row of each class over every level (the root's strong list
    holds itself, its weak list nothing).
    """
    classify = leaf_classify_impl or classify_level_reference
    S, W = cfg.strong_cap, cfg.weak_cap
    B = tree.z.shape[0]
    dev = tree.z.device

    root = torch.full((B, 1, S), -1, dtype=torch.int32, device=dev)
    root[..., 0] = 0                                   # root: self
    strong = [root]
    weak = [torch.full((B, 1, W), -1, dtype=torch.int32, device=dev)]

    if cfg.nlevels == 0:
        # Degenerate 1-box problem: the root strong list is *defined* as
        # self, so only the swapped-theta reclassification applies.
        count_levels()
        valid = root >= 0
        c0, r0 = tree.centers[0], tree.radii[0]
        ccx, ccy, rc = gather_geometry(root, valid, c0, r0)
        masks = (valid, torch.zeros_like(valid)) + swapped_masks(
            c0.real, c0.imag, r0, ccx, ccy, rc, valid, cfg)
        p2p, p2l, m2p = (_stream_compact(root, m, S) for m in masks[2:])
        counts = [torch.stack([m.sum(dim=-1) for m in masks], dim=-1)
                  .to(torch.int32)]
    else:
        counts = []
        for l in range(1, cfg.nlevels + 1):
            lists, cnt = classify(strong[-1], tree.centers[l],
                                  tree.radii[l], cfg, l == cfg.nlevels)
            strong.append(lists[0])
            weak.append(lists[1])
            counts.append(cnt)
        p2p, p2l, m2p = lists[2:]
    most = torch.cat(counts, dim=1).amax(dim=1)               # (B, 5)
    most[:, 0].clamp_(min=1)
    caps = torch.full_like(most, S)
    caps[:, 1] = W
    margins = caps - most
    return Connectivity(strong=tuple(strong), weak=tuple(weak),
                        p2p=p2p, p2l=p2l, m2p=m2p,
                        overflow=_overflow_of(margins), margins=margins)


def connectivity_stats(conn: Connectivity) -> dict:
    """Interaction counts per phase (the paper's Table 5.1 analysis), the
    reference's keys: ``m2l_pairs``, ``p2p_pairs``, ``p2l_pairs``,
    ``m2p_pairs`` (occupied list entries), ``strong_max``/``weak_max``
    (the fullest row of any level), ``overflow`` and ``margins`` (per
    ``MARGIN_CLASSES``).

    The whole ``Connectivity`` goes to the host in ONE transfer (every
    field flattened into one device tensor), then numpy counts. For a
    B = 1 plan this is the reference's dict. For B > 1 the pair counts
    are summed over the B problems, ``strong_max``/``weak_max`` and
    ``overflow`` are the largest over the problems and ``margins`` the
    smallest per class (the reduction of ``solver.host_health``).
    """
    fields = list(conn.strong) + list(conn.weak) + [
        conn.p2p, conn.p2l, conn.m2p, conn.overflow, conn.margins]
    flat = torch.cat([f.reshape(-1).to(torch.int32) for f in fields])
    host = flat.cpu().numpy()
    parts, at = [], 0
    for f in fields:
        parts.append(host[at:at + f.numel()].reshape(tuple(f.shape)))
        at += f.numel()
    nl = len(conn.strong)
    strong, weak = parts[:nl], parts[nl:2 * nl]
    p2p, p2l, m2p, overflow, margins = parts[2 * nl:]
    margins = margins.reshape(-1, len(MARGIN_CLASSES)).min(axis=0)
    return {
        "m2l_pairs": int(sum(int((w >= 0).sum()) for w in weak)),
        "p2p_pairs": int((p2p >= 0).sum()),
        "p2l_pairs": int((p2l >= 0).sum()),
        "m2p_pairs": int((m2p >= 0).sum()),
        "strong_max": max(int((s >= 0).sum(-1).max()) for s in strong),
        "weak_max": max(int((w >= 0).sum(-1).max()) for w in weak),
        "overflow": int(overflow.max()),
        "margins": {c: int(m) for c, m in zip(MARGIN_CLASSES, margins)},
    }
