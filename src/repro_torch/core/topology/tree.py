"""Asymmetric adaptive FMM tree (paper §2) — single-sort build, batched.

Boxes are split at the particle *median*, twice per level, along the most
eccentric axis -> a perfectly balanced 4-ary pyramid. Because splits happen
at exact ranks, box b at level l owns the contiguous rank-slice
``[bounds[l][b], bounds[l][b+1])`` where the bounds depend only on (N, l):
a *static memory layout*.

The build sorts exactly **twice** (one stable ``torch.argsort`` per
coordinate) and then maintains, through every split, two id arrays
``A_x``/``A_y`` that are segment-contiguous at the static rank bounds and
internally sorted by x resp. y. Each median split is O(N) sort-free work:
segment extents are gathers of the sorted runs' endpoints, "goes left" is
a static positional predicate scattered to particle ids, and both arrays
are stable-partitioned at the static median ranks with one cumulative sum
and one scatter (every destination is distinct, so the scatter is a
permutation and deterministic on CUDA too).

Every tensor carries a leading problem axis B: B problems of one config
are one build. The result is bit-identical to ``repro.core.topology.
build_tree`` for each problem — the box radii use ``rounding.hypot_xla``
to copy the reference's roundings — and to ``build_tree_lexsort``, the
seed build of one lexicographic sort a split, kept as its oracle.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..config import FmmConfig, level_bounds, segment_ids, split_bounds
from ..constants import device_constant
from .rounding import hypot_xla


class Tree(NamedTuple):
    """Sorted particles + per-level box geometry, batched. All shapes static."""

    perm: torch.Tensor       # (B, N) int64; sorted[b, i] is input index perm[b, i]
    z: torch.Tensor          # (B, N) complex, rank-sorted positions
    q: torch.Tensor          # (B, N) complex, rank-sorted strengths
    centers: tuple           # level l: (B, 4**l) complex
    radii: tuple             # level l: (B, 4**l) real


def _const(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)


def _partition(order, left_of, starts_pos, mids_pos, offs_pos):
    """Stable-partition ``order`` within static segments by a per-id flag.

    ``order``: (B, N) particle ids, segment-contiguous at the static
    bounds and internally sorted by one coordinate. ``left_of``: (B, N)
    bool per particle *id*. ``starts_pos``/``mids_pos``/``offs_pos``:
    (N,) static per-position segment start / median rank / offset within
    the segment. Left entries keep their relative order in ``[start,
    mid)``, right entries in ``[mid, end)``.
    """
    f = torch.gather(left_of, -1, order)
    fi = f.to(torch.int64)
    lefts = torch.cumsum(fi, dim=-1) - fi          # exclusive: lefts in [0, p)
    seg_l = lefts - lefts[:, starts_pos]           # lefts before p in segment
    seg_r = offs_pos - seg_l                       # rights before p in segment
    dest = torch.where(f, starts_pos + seg_l, mids_pos + seg_r)
    return torch.zeros_like(order).scatter_(-1, dest, order)


def build_tree(z: torch.Tensor, q: torch.Tensor, cfg: FmmConfig) -> Tree:
    """Sort B problems' particles into the static pyramid layout.

    ``z``/``q``: (B, N) complex. Exactly two full-array sorts regardless
    of depth; everything else is cumsum/gather/scatter.
    """
    cdt = cfg.torch_complex
    z = z.to(cdt)
    q = q.to(cdt)
    x = z.real.contiguous()
    y = z.imag.contiguous()
    B, N = x.shape
    L = cfg.nlevels
    dev = x.device

    if L == 0:
        perm = torch.arange(N, device=dev).expand(B, N).contiguous()
    else:
        ax = torch.argsort(x, dim=-1, stable=True)      # full sort 1
        ay = torch.argsort(y, dim=-1, stable=True)      # full sort 2
        tables = split_tables(N, L, dev)
        ar = torch.arange(N, device=dev)
        split_x = None
        for s in range(2 * L):
            b = tables.bounds[s]                         # (2**s + 1,) bounds
            mids = tables.mids[s]                        # median ranks
            # static per-position segment id / start / median / offset,
            # expanded on the device from the (2**s + 1) bounds
            sid = torch.repeat_interleave(
                torch.arange(2**s, device=dev), b[1:] - b[:-1],
                output_size=N)
            starts_pos = b[:-1][sid]
            mids_pos = mids[sid]
            offs_pos = ar - starts_pos
            # sorted-run endpoints ARE the segment extents
            xmn = torch.gather(x, -1, ax[:, b[:-1]])
            xmx = torch.gather(x, -1, ax[:, b[1:] - 1])
            ymn = torch.gather(y, -1, ay[:, b[:-1]])
            ymx = torch.gather(y, -1, ay[:, b[1:] - 1])
            split_x = (xmx - xmn) >= (ymx - ymn)         # (B, 2**s)
            # positional "first half of my segment" flag
            pos_left = (ar < mids_pos).expand(B, N)
            xleft = torch.zeros_like(pos_left).scatter_(-1, ax, pos_left)
            yleft = torch.zeros_like(pos_left).scatter_(-1, ay, pos_left)
            sid_of_id = torch.zeros_like(ax).scatter_(-1, ax,
                                                      sid.expand(B, N))
            goes_left = torch.where(torch.gather(split_x, -1, sid_of_id),
                                    xleft, yleft)
            ax = _partition(ax, goes_left, starts_pos, mids_pos, offs_pos)
            ay = _partition(ay, goes_left, starts_pos, mids_pos, offs_pos)
        # Final rank order within each leaf = ascending in the axis its
        # parent split on: a positionwise select between the two arrays.
        perm = torch.where(split_x[:, leaf_layout(N, L, dev).lid // 2],
                           ax, ay)

    xs = torch.gather(x, -1, perm)
    ys = torch.gather(y, -1, perm)
    z_sorted = torch.complex(xs, ys)
    q_sorted = torch.gather(q, -1, perm)
    centers, radii = _level_geometry(xs, ys, cfg)
    return Tree(perm=perm, z=z_sorted, q=q_sorted,
                centers=centers, radii=radii)


def _level_geometry(xs: torch.Tensor, ys: torch.Tensor, cfg: FmmConfig):
    """Shrink-to-fit centers/radii for every level from ONE leaf pass.

    Leaf extents are min/max over the dense (4**L, n_max) leaf planes of
    the static ``leaf_particle_index`` (padding points at the leaf's own
    first rank, which leaves min and max unchanged); every coarser level
    is a 4-child min/max of the level below (exact).
    """
    lay = leaf_layout(cfg.n, cfg.nlevels, xs.device)
    B = xs.shape[0]
    shape = (B,) + tuple(lay.valid.shape)
    xl = xs[:, lay.flat].view(shape)
    yl = ys[:, lay.flat].view(shape)
    xmn, xmx = xl.amin(dim=-1), xl.amax(dim=-1)
    ymn, ymx = yl.amin(dim=-1), yl.amax(dim=-1)
    centers: list = [None] * (cfg.nlevels + 1)
    radii: list = [None] * (cfg.nlevels + 1)
    for l in range(cfg.nlevels, -1, -1):
        centers[l] = torch.complex(0.5 * (xmn + xmx), 0.5 * (ymn + ymx))
        radii[l] = 0.5 * hypot_xla(xmx - xmn, ymx - ymn)
        if l > 0:
            xmn = xmn.view(B, -1, 4).amin(dim=-1)
            xmx = xmx.view(B, -1, 4).amax(dim=-1)
            ymn = ymn.view(B, -1, 4).amin(dim=-1)
            ymx = ymx.view(B, -1, 4).amax(dim=-1)
    return tuple(centers), tuple(radii)


def _seg_minmax(v: torch.Tensor, sid: torch.Tensor, nseg: int):
    """Per-segment min and max of (B, N) values over the static (N,)
    segment ids (an empty segment reads +inf / -inf)."""
    idx = sid.expand_as(v)
    shape = (v.shape[0], nseg)
    mn = torch.full(shape, float("inf"), dtype=v.dtype, device=v.device)
    mx = torch.full(shape, float("-inf"), dtype=v.dtype, device=v.device)
    return (mn.scatter_reduce_(-1, idx, v, "amin", include_self=False),
            mx.scatter_reduce_(-1, idx, v, "amax", include_self=False))


def build_tree_lexsort(z: torch.Tensor, q: torch.Tensor,
                       cfg: FmmConfig) -> Tree:
    """The seed build, one full lexicographic sort (segment, then the
    split coordinate) per split, kept as the parity oracle of
    ``build_tree``: the twin of ``repro.core.topology.build_tree_lexsort``
    on (B, N) problems."""
    cdt = cfg.torch_complex
    z = z.to(cdt)
    q = q.to(cdt)
    x = z.real.contiguous()
    y = z.imag.contiguous()
    B, N = x.shape
    dev = x.device
    perm = torch.arange(N, device=dev).expand(B, N).contiguous()
    sb = split_bounds(N, 2 * cfg.nlevels)
    for s in range(2 * cfg.nlevels):
        sid = _const(segment_ids(sb[s]), dev)
        xmn, xmx = _seg_minmax(x, sid, 2**s)
        ymn, ymx = _seg_minmax(y, sid, 2**s)
        split_x = (xmx - xmn) >= (ymx - ymn)
        coord = torch.where(torch.gather(split_x, -1, sid.expand(B, N)), x, y)
        # stable sort by coordinate, then stable by segment: lexicographic
        by_coord = torch.argsort(coord, dim=-1, stable=True)
        order = torch.gather(by_coord, -1, torch.argsort(
            sid[by_coord], dim=-1, stable=True))
        x, y, perm = (torch.gather(a, -1, order) for a in (x, y, perm))

    centers, radii = [], []
    for l, lb in enumerate(level_bounds(cfg)):
        sid = _const(segment_ids(lb), dev)
        xmn, xmx = _seg_minmax(x, sid, 4**l)
        ymn, ymx = _seg_minmax(y, sid, 4**l)
        centers.append(torch.complex(0.5 * (xmn + xmx), 0.5 * (ymn + ymx)))
        radii.append(0.5 * hypot_xla(xmx - xmn, ymx - ymn))
    return Tree(perm=perm, z=torch.complex(x, y),
                q=torch.gather(q, -1, perm), centers=tuple(centers),
                radii=tuple(radii))


@dataclasses.dataclass(frozen=True, eq=False)
class SplitTables:
    """The static tables of the 2 * nlevels median splits of one
    (N, nlevels) on one device: for split s, the 2**s + 1 segment bounds
    and the 2**s median ranks (views of one device tensor)."""

    bounds: tuple            # split s: (2**s + 1,) int64
    mids: tuple              # split s: (2**s,) int64


@device_constant(maxsize=8)
def split_tables(n: int, nlevels: int, device: torch.device) -> SplitTables:
    """``split_bounds`` and its median ranks as device tensors, copied
    once per (N, nlevels, device) while any holder keeps them."""
    sb = split_bounds(n, 2 * nlevels)
    parts = []
    for s in range(2 * nlevels):
        parts += [sb[s], sb[s + 1][1::2]]
    if not parts:
        return SplitTables(bounds=(), mids=())
    views = torch.split(_const(np.concatenate(parts), device),
                        [len(a) for a in parts])
    return SplitTables(bounds=views[0::2], mids=views[1::2])


@dataclasses.dataclass(frozen=True, eq=False)
class LeafLayout:
    """The static dense leaf layout of one (N, nlevels) on one device."""

    flat: torch.Tensor       # (4**L * n_max,) int64 rank per dense slot;
    #                          padded slots repeat the leaf's first rank
    valid: torch.Tensor      # (4**L, n_max) bool, False in padded slots
    ranks: torch.Tensor      # (4**L, n_max) int32 rank per slot, -1 padded
    slot_of_rank: torch.Tensor  # (N,) int64 flat dense slot of each rank
    lid: torch.Tensor        # (N,) int64 leaf box owning each rank
    bounds: torch.Tensor     # (4**L + 1,) int32 first rank of each leaf,
    #                          then N: leaf b owns [bounds[b], bounds[b+1])


_LAYOUT_BUILDS = [0]


def layout_builds() -> int:
    """How many leaf layouts this process has built (each is host work
    and a copy to the device)."""
    return _LAYOUT_BUILDS[0]


@device_constant(maxsize=8)
def leaf_layout(n: int, nlevels: int, device: torch.device) -> LeafLayout:
    """``leaf_particle_index`` and its inverse as device tensors, built
    once per (N, nlevels, device) while any holder keeps it — the layout
    depends on nothing else. A solver's programs hold the layouts they
    read, so a layout lives as long as a program that reads it, however
    many other sizes are served in between."""
    _LAYOUT_BUILDS[0] += 1
    cfg = FmmConfig(n=n, nlevels=nlevels)
    idx = leaf_particle_index(cfg)
    valid = idx >= 0
    flat = np.where(valid, idx, idx[:, :1]).reshape(-1)
    slot_of_rank = np.empty(n, np.int64)
    slot_of_rank[idx[valid]] = np.nonzero(valid.reshape(-1))[0]
    return LeafLayout(flat=_const(flat, device),
                      valid=torch.as_tensor(valid, device=device),
                      ranks=torch.as_tensor(idx, device=device),
                      slot_of_rank=_const(slot_of_rank, device),
                      lid=_const(leaf_ids(cfg), device),
                      bounds=torch.as_tensor(level_bounds(cfg)[-1].astype(
                          np.int32), device=device))


def leaf_particle_index(cfg: FmmConfig) -> np.ndarray:
    """(4**L, n_max) int32 gather map leaf-box -> particle ranks, -1 padded.

    Purely static (depends only on N and nlevels): the paper's "static
    layout of memory" made literal.
    """
    lb = level_bounds(cfg)[-1]
    sizes = np.diff(lb)
    n_max = int(sizes.max())
    col = np.arange(n_max, dtype=np.int64)
    idx = lb[:-1, None] + col[None, :]
    return np.where(col[None, :] < sizes[:, None], idx, -1).astype(np.int32)


def leaf_particle_index_loop(cfg: FmmConfig) -> np.ndarray:
    """The seed O(4**L) loop construction of ``leaf_particle_index``,
    kept as its parity oracle."""
    lb = level_bounds(cfg)[-1]
    sizes = np.diff(lb)
    idx = np.full((len(sizes), int(sizes.max())), -1, dtype=np.int32)
    for b in range(len(sizes)):
        idx[b, :sizes[b]] = np.arange(lb[b], lb[b + 1], dtype=np.int32)
    return idx


def leaf_ids(cfg: FmmConfig) -> np.ndarray:
    """(N,) int32: leaf box owning each rank."""
    return segment_ids(level_bounds(cfg)[-1])
