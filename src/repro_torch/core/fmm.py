"""The adaptive FMM pipeline (paper §3.3) on B problems at once.

Phases (paper naming):
  topological: build_tree (sort) + build_connectivity (connect)
  upward:      P2M , M2M
  downward:    M2L , L2L (+ P2L)
  evaluation:  L2P (+ M2P) , P2P

Every tensor carries a leading problem axis B (B = 1 for one problem):
B problems of one config share every static shape, so each phase is one
pass — and each kernel one launch — for the whole batch. On a one-problem
plan the charges may carry K rows instead (``with_charges``): K densities
on one geometry. Then every charge-dependent plane (charges, multipoles,
locals, phi) has a leading density axis K while the tree, its centres
and radii and the lists keep their single row, which the sweeps here
broadcast and the kernels read once (the density axis). The sweeps here
are plain torch: they are the "reference" backend and the twins the
kernels of ``repro_torch.kernels`` are checked against. ``fmm_build``
and ``fmm_evaluate`` take the hooks kernels are swapped into: the main
path's (``leaf_classify_impl``, ``upward_impl``, ``m2l_fused_impl``,
``p2l_impl``, ``eval_fused_impl``) and the per-phase path's
(``m2l_impl`` one level at a time, ``l2p_impl``, ``p2p_impl``) — the
reference's hooks, minus the static leaf index argument, which the port
reads from its cached ``leaf_layout``, plus ``upward_impl``, which the
reference does not have (its upward pass is plain jnp).

Sums over a leaf's particles run over dense (B, 4**L, n_max) planes of
the static ``leaf_particle_index`` along the last axis, and results go
back to rank order by a gather (each rank owns one slot) — no
``index_add_``, whose atomics would make CUDA results change from run to
run.

The downward pass takes each level's M2L contribution from the fused
hook, the per-level hook or the plain sweep, and folds them all with one
L2L loop (``_downward``).

Each phase runs inside a ``repro_torch.trace.phase`` named
``fmm::<phase>`` (tree, connectivity, upward, downward, evaluation;
charges, where new charges go onto a held plan, ``with_charges``): a
host span on an eager call, and a device mark inside a captured graph,
so that every replay reads the device time of each phase
(``repro_torch.trace``).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .. import trace
from ..device import resolve_device
from ..errors import CapOverflowError
from . import expansions as E
from .config import FmmConfig
from .constants import device_constant
from .topology import (MARGIN_CLASSES, Connectivity, Tree,
                       build_connectivity, build_tree, connectivity_stats,
                       leaf_layout)


class FmmPlan(NamedTuple):
    """Built tree + connectivity of B problems."""

    tree: Tree
    conn: Connectivity


#: Order of the per-class entries in ``Health.margins``.
HEALTH_CLASSES = MARGIN_CLASSES


class Health(NamedTuple):
    """Health plane of one evaluation of B problems, computed beside phi:

      margins           (B, 5) int32, ``HEALTH_CLASSES`` order — slots
                        left on the fullest interaction list per class;
                        negative = that many entries were dropped
      overflow          (B,) int32 — dropped-entry count (0 = healthy)
      nonfinite_input   (B,) bool — any NaN/Inf in z or q
      nonfinite_output  (B,) bool — any NaN/Inf in phi
    """

    margins: torch.Tensor
    overflow: torch.Tensor
    nonfinite_input: torch.Tensor
    nonfinite_output: torch.Tensor


def _any_nonfinite(*arrays: torch.Tensor) -> torch.Tensor:
    flag = None
    for a in arrays:
        f = ~torch.isfinite(a).view(a.shape[0], -1).all(dim=-1)
        flag = f if flag is None else flag | f
    return flag


def health_of(plan: FmmPlan, z: torch.Tensor, q: torch.Tensor,
              phi: torch.Tensor) -> Health:
    """The health plane of an evaluation of ``plan`` on (z, q) -> phi."""
    return Health(margins=plan.conn.margins, overflow=plan.conn.overflow,
                  nonfinite_input=_any_nonfinite(z, q),
                  nonfinite_output=_any_nonfinite(phi))


# ---------------------------------------------------------------------------
# dense leaf planes (static layout)
# ---------------------------------------------------------------------------

def leaf_planes(values: torch.Tensor, cfg: FmmConfig) -> torch.Tensor:
    """(B, N) rank-order values -> (B, 4**L, n_max) dense leaf planes with
    zeros in the padded slots."""
    lay = leaf_layout(cfg.n, cfg.nlevels, values.device)
    B = values.shape[0]
    dense = values[:, lay.flat].view((B,) + tuple(lay.valid.shape))
    return torch.where(lay.valid, dense, torch.zeros(
        (), dtype=values.dtype, device=values.device))


def from_leaves(values: torch.Tensor, cfg: FmmConfig) -> torch.Tensor:
    """(B, 4**L, n_max) dense leaf planes -> (B, N) rank order: a gather
    (each rank owns exactly one slot)."""
    lay = leaf_layout(cfg.n, cfg.nlevels, values.device)
    return values.reshape(values.shape[0], -1)[:, lay.slot_of_rank]


def rows(table: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``table[b, index[b, ...]]`` for a (B, M, ...) table and a (B, ...)
    index — a per-problem row gather."""
    B = table.shape[0]
    bidx = torch.arange(B, device=table.device).view(
        (B,) + (1,) * (index.dim() - 1))
    return table[bidx, index]


# ---------------------------------------------------------------------------
# upward phase
# ---------------------------------------------------------------------------

def effective_radii(tree: Tree, cfg: FmmConfig) -> list:
    """Per-level normalization radii: the box radius floored at 1e-6 of
    the level maximum (point-like boxes would otherwise give 0/0)."""
    out = []
    for l in range(cfg.nlevels + 1):
        r = tree.radii[l]
        out.append(torch.maximum(
            r, 1e-6 * r.amax(dim=-1, keepdim=True) + 1e-300))
    return out


def p2m(tree: Tree, cfg: FmmConfig, rho=None) -> torch.Tensor:
    """Leaf multipole expansions, radius-normalized; (B, 4**L, p+1)."""
    L = cfg.nlevels
    if rho is None:
        rho = effective_radii(tree, cfg)[L]
    zl = leaf_planes(tree.z, cfg)
    ql = leaf_planes(tree.q, cfg)
    rl = rho[..., None]
    w = (zl - tree.centers[L][..., None]) / rl

    if cfg.kernel == "harmonic":
        coeffs = [torch.zeros_like(ql[..., 0])]
        pw = ql / rl
        for _ in range(cfg.p):
            coeffs.append(-pw.sum(dim=-1))
            pw = pw * w
    else:  # log: a~_0 = sum q; a~_j = -sum q w^j / j
        coeffs = [ql.sum(dim=-1)]
        pw = ql
        for j in range(1, cfg.p + 1):
            pw = pw * w
            coeffs.append(-pw.sum(dim=-1) / j)
    return torch.stack(coeffs, dim=-1)


def m2m_level(child_coeffs, tree: Tree, l: int, cfg: FmmConfig,
              rho_child, rho_parent) -> torch.Tensor:
    """Shift level-(l+1) multipoles into level-l parents; sum 4 children."""
    dev = child_coeffs.device
    parent = torch.arange(4 ** (l + 1), device=dev) // 4
    t = tree.centers[l + 1] - tree.centers[l][:, parent]
    rp = rho_parent[:, parent]
    u = t / rp
    ratio = (rho_child / rp).to(child_coeffs.dtype)
    shifted = E.m2m_norm(child_coeffs, u, ratio)
    B = shifted.shape[0]
    return shifted.view(B, 4**l, 4, cfg.p + 1).sum(dim=2)


def upward(tree: Tree, cfg: FmmConfig, rho=None) -> list:
    """Normalized multipole coefficients per level (l -> (B, 4**l, p+1))."""
    if rho is None:
        rho = effective_radii(tree, cfg)
    m = [None] * (cfg.nlevels + 1)
    m[cfg.nlevels] = p2m(tree, cfg, rho[cfg.nlevels])
    for l in range(cfg.nlevels - 1, -1, -1):
        m[l] = m2m_level(m[l + 1], tree, l, cfg, rho[l + 1], rho[l])
    return m


# ---------------------------------------------------------------------------
# downward phase
# ---------------------------------------------------------------------------

def m2l_level(mult, weak, centers, cfg: FmmConfig, mat, rho) -> torch.Tensor:
    """Sum of M2L translations into each box of one level (normalized),
    chunked over the padded weak list to bound the working set."""
    B, nb, W = weak.shape
    c = cfg.m2l_chunk
    out = torch.zeros((B, nb, cfg.p + 1), dtype=mult.dtype,
                      device=mult.device)
    one = torch.ones((), dtype=centers.dtype, device=centers.device)
    zero = torch.zeros((), dtype=rho.dtype, device=rho.device)
    for s in range(0, W, c):
        wk = weak[..., s:s + c].long()
        mask = wk >= 0
        src = torch.where(mask, wk, torch.zeros_like(wk))
        a = torch.where(mask[..., None], rows(mult, src),
                        torch.zeros((), dtype=mult.dtype,
                                    device=mult.device))
        r = torch.where(mask, centers[..., None] - rows(centers, src), one)
        rho_s = torch.where(mask, rows(rho, src), zero)
        rho_t = rho[..., None]
        if cfg.translations == "mxu":
            contrib = E.m2l_norm(a, r, rho_s, rho_t, mat)
        else:
            contrib = E.m2l_norm_horner(a, r, rho_s, rho_t)
        out = out + contrib.sum(dim=2)
    return out


def l2l_level(parent_local, tree: Tree, l: int, cfg: FmmConfig,
              rho_child, rho_parent) -> torch.Tensor:
    """Shift level-(l-1) locals down to level-l children (normalized)."""
    parent = torch.arange(4**l, device=parent_local.device) // 4
    s = tree.centers[l] - tree.centers[l - 1][:, parent]
    rp = rho_parent[:, parent]
    v = s / rp
    ratio = (rho_child / rp).to(parent_local.dtype)
    return E.l2l_norm(parent_local[:, parent], v, ratio)


def p2l_sweep(local, tree: Tree, conn: Connectivity, cfg: FmmConfig,
              rho) -> torch.Tensor:
    """Direct particle->local shifts for swapped-theta leaf pairs
    (radius-normalized: b~_l = sum q/(x-z0) * (rho_t/(x-z0))^l), one
    list slot at a time."""
    z0 = tree.centers[cfg.nlevels][..., None]
    zl = leaf_planes(tree.z, cfg)
    ql = leaf_planes(tree.q, cfg)
    pvalid = leaf_layout(cfg.n, cfg.nlevels, zl.device).valid
    czero = torch.zeros((), dtype=zl.dtype, device=zl.device)
    rl = rho[..., None]
    out = local
    for s in range(conn.p2l.shape[-1]):
        src = conn.p2l[..., s].long()
        bmask = src >= 0
        srcc = torch.where(bmask, src, torch.zeros_like(src))
        pmask = pvalid[srcc] & bmask[..., None]
        pz = rows(zl, srcc)
        pq = torch.where(pmask, rows(ql, srcc), czero)
        inv = torch.where(pmask, 1.0 / (pz - z0), czero)
        w = rl * inv
        if cfg.kernel == "harmonic":
            pw = pq * inv
            updates = []
            for _ in range(cfg.p + 1):
                updates.append(pw.sum(dim=-1))
                pw = pw * w
        else:
            logs = torch.where(pmask, torch.log(z0 - pz), czero)
            updates = [(pq * logs).sum(dim=-1)]
            pw = pq * w
            for l in range(1, cfg.p + 1):
                updates.append(-(pw.sum(dim=-1)) / l)
                pw = pw * w
        out = out + torch.stack(updates, dim=-1)
    return out


def _apply_p2l(local, tree, conn, cfg: FmmConfig, rho, p2l_impl):
    """Fold the leaf P2L contribution into ``local`` — via the plain
    sweep, or a ``p2l_impl(tree, conn, cfg, rho_leaf)`` hook that
    returns the (B, nbox, p+1) contribution (the kernel)."""
    if not (cfg.use_p2l_m2p and cfg.nlevels > 0):
        return local
    if p2l_impl is None:
        return p2l_sweep(local, tree, conn, cfg, rho[cfg.nlevels])
    return local + p2l_impl(tree, conn, cfg, rho[cfg.nlevels])


@device_constant(maxsize=16)
def m2l_mat(p: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The constant (p+1, p+1) M2L matrix H as a tensor, built once per
    (p, dtype, device) while any holder keeps it, and shared by every
    later call (read only)."""
    return torch.as_tensor(E.m2l_matrix(p), dtype=dtype, device=device)


def downward(mult, tree: Tree, conn: Connectivity, cfg: FmmConfig,
             rho=None, p2l_impl=None) -> torch.Tensor:
    """Local coefficients at the leaf level (M2L, L2L, P2L), level by
    level — the plain sweep."""
    return _downward(mult, tree, conn, cfg, rho, p2l_impl)


def _downward(mult, tree: Tree, conn: Connectivity, cfg: FmmConfig,
              rho=None, p2l_impl=None, m2l_impl=None,
              m2l_fused_impl=None) -> torch.Tensor:
    """The downward pass with its hooks. Each level's (B, 4**l, p+1) M2L
    contribution, l = 1..L (with no level below the root, the root's
    own), comes from ``m2l_fused_impl(mult, weak, centers, cfg, rho)``
    (every level in one launch), else from ``m2l_impl(mult, weak,
    centers, cfg, rho)`` once a level (one launch a level), else from
    the plain ``m2l_level``. One fold then runs L2L from the root down,
    adding each level's contribution after its L2L, and the leaf P2L
    (``_apply_p2l``) ends the pass."""
    if rho is None:
        rho = effective_radii(tree, cfg)
    levels = range(1, cfg.nlevels + 1) or (0,)
    if m2l_fused_impl is not None:
        m2l = m2l_fused_impl(mult, conn.weak, tree.centers, cfg, rho)
    else:
        if m2l_impl is None:
            mat = m2l_mat(cfg.p, cfg.torch_real, mult[-1].device)

            def m2l_impl(m, weak, centers, c, r):
                return m2l_level(m, weak, centers, c, mat, r)

        m2l = [m2l_impl(mult[l], conn.weak[l], tree.centers[l], cfg, rho[l])
               for l in levels]
    B = mult[-1].shape[0]
    local = torch.zeros((B, 1, cfg.p + 1), dtype=mult[-1].dtype,
                        device=mult[-1].device)
    for l, contrib in zip(levels, m2l):
        if l > 0:
            local = l2l_level(local, tree, l, cfg, rho[l], rho[l - 1])
        local = local + contrib
    return _apply_p2l(local, tree, conn, cfg, rho, p2l_impl)


# ---------------------------------------------------------------------------
# evaluation phase
# ---------------------------------------------------------------------------

def l2p(local, tree: Tree, cfg: FmmConfig, rho=None) -> torch.Tensor:
    """Evaluate leaf local expansions at the (sorted) particles; (B, N)."""
    lid = leaf_layout(cfg.n, cfg.nlevels, local.device).lid
    if rho is None:
        rho = effective_radii(tree, cfg)[cfg.nlevels]
    t = (tree.z - tree.centers[cfg.nlevels][:, lid]) / rho[:, lid]
    b = local[:, lid]                                     # (B, N, p+1)
    acc = b[..., cfg.p]
    for j in range(cfg.p - 1, -1, -1):
        acc = acc * t + b[..., j]
    return acc


def m2p_sweep(phi, mult_leaf, tree: Tree, conn: Connectivity,
              cfg: FmmConfig, rho=None) -> torch.Tensor:
    """Evaluate source-box multipoles directly at target particles
    (normalized: Horner in w = rho_src/(z - z0_src))."""
    dev = phi.device
    lid = leaf_layout(cfg.n, cfg.nlevels, dev).lid
    z0 = tree.centers[cfg.nlevels]
    if rho is None:
        rho = effective_radii(tree, cfg)[cfg.nlevels]
    czero = torch.zeros((), dtype=phi.dtype, device=dev)
    for s in range(conn.m2p.shape[-1]):
        src = conn.m2p[..., s].long()[:, lid]             # (B, N)
        mask = src >= 0
        srcc = torch.where(mask, src, torch.zeros_like(src))
        a = rows(mult_leaf, srcc)                         # (B, N, p+1)
        dz = tree.z - rows(z0, srcc)
        w = torch.where(mask, rows(rho, srcc) / dz, czero)
        acc = a[..., cfg.p]
        for j in range(cfg.p - 1, 0, -1):
            acc = acc * w + a[..., j]
        acc = acc * w
        if cfg.kernel == "log":
            acc = acc + a[..., 0] * torch.where(
                mask, torch.log(torch.where(mask, dz, czero + 1)), czero)
        phi = phi + torch.where(mask, acc, czero)
    return phi


def p2p_sweep(phi, tree: Tree, conn: Connectivity,
              cfg: FmmConfig) -> torch.Tensor:
    """Near-field direct evaluation over the leaf P2P lists (Alg. 3.7),
    one list slot at a time over (B, nb, n_t, n_s) pairwise blocks.
    Self-interaction is excluded by particle identity (global rank), not
    position: distinct coincident particles contribute their (singular)
    mutual term — the sum_{j != i} semantics of eq. (1.1)."""
    dev = phi.device
    ranks = leaf_layout(cfg.n, cfg.nlevels, dev).ranks.long()
    tz = leaf_planes(tree.z, cfg)                         # (B, nb, n_max)
    sq_all = leaf_planes(tree.q, cfg)
    czero = torch.zeros((), dtype=phi.dtype, device=dev)
    acc = torch.zeros_like(tz)
    for s in range(conn.p2p.shape[-1]):
        src = conn.p2p[..., s].long()
        bmask = src >= 0
        srcc = torch.where(bmask, src, torch.zeros_like(src))
        sidx = ranks[srcc]                                # (B, nb, n_max)
        smask = (sidx >= 0) & bmask[..., None]
        sz = rows(tz, srcc)
        sq = torch.where(smask, rows(sq_all, srcc), czero)
        diff = sz[..., None, :] - tz[..., :, None]        # (B, nb, n_t, n_s)
        ok = smask[..., None, :] & (sidx[..., None, :] != ranks[:, :, None])
        if cfg.kernel == "harmonic":
            contrib = (torch.where(ok, sq[..., None, :], czero)
                       / torch.where(ok, diff, czero + 1))
        else:
            contrib = torch.where(ok, sq[..., None, :] * torch.log(
                torch.where(ok, -diff, czero + 1)), czero)
        acc = acc + contrib.sum(dim=-1)
    return phi + from_leaves(acc, cfg)


# ---------------------------------------------------------------------------
# full pipeline
# ---------------------------------------------------------------------------

def fmm_build(z: torch.Tensor, q: torch.Tensor, cfg: FmmConfig,
              leaf_classify_impl=None, connect=None) -> FmmPlan:
    """Topological phase of B problems ((B, N) complex z, q): sort
    (single-sort tree build) + connect. ``leaf_classify_impl`` is the
    per-level topology hook (the CUDA topology kernel, one launch a
    level; see ``build_connectivity``);
    ``connect`` the connectivity builder (default: this module's
    ``build_connectivity`` binding, read at the call)."""
    connect = connect or build_connectivity
    with trace.phase("fmm::tree"):
        tree = build_tree(z, q, cfg)
    with trace.phase("fmm::connectivity"):
        conn = connect(tree, cfg, leaf_classify_impl=leaf_classify_impl)
    return FmmPlan(tree=tree, conn=conn)


def fmm_evaluate(plan: FmmPlan, cfg: FmmConfig, p2p_impl=None,
                 m2l_impl=None, l2p_impl=None, m2l_fused_impl=None,
                 p2l_impl=None, eval_fused_impl=None,
                 upward_impl=None) -> torch.Tensor:
    """Upward/downward/evaluation on a built plan; returns (B, N) phi in
    rank (sorted) order.

    ``upward_impl(tree, cfg, rho)``, given the per-level
    ``effective_radii``, returns the per-level (B, 4**l, p+1)
    multipoles in place of the plain ``upward`` (the kernel: the whole
    pass in at most two launches).

    The downward pass (``_downward``) takes each level's M2L
    contribution from ``m2l_fused_impl`` (every level in one launch),
    else ``m2l_impl`` (one level a call), else the plain sweep, and folds
    them with one L2L loop; ``p2l_impl`` replaces its P2L sweep.
    ``p2p_impl(tree, conn, cfg)`` and ``l2p_impl(local, tree, cfg)``
    replace the near-field and L2P sweeps (the per-phase path; M2P stays
    the plain sweep, as in the reference); ``eval_fused_impl(local,
    mult_leaf, tree, conn, cfg) -> (B, N)`` takes precedence over them:
    it computes the whole evaluation phase (L2P + M2P + P2P) in one
    launch. Hooks left ``None`` run the plain sweeps.
    """
    tree, conn = plan.tree, plan.conn
    with trace.phase("fmm::upward"):
        mult = (upward(tree, cfg) if upward_impl is None
                else upward_impl(tree, cfg, effective_radii(tree, cfg)))

    with trace.phase("fmm::downward"):
        local = _downward(mult, tree, conn, cfg, p2l_impl=p2l_impl,
                          m2l_impl=m2l_impl, m2l_fused_impl=m2l_fused_impl)

    with trace.phase("fmm::evaluation"):
        if eval_fused_impl is not None:
            return eval_fused_impl(local, mult[cfg.nlevels], tree, conn, cfg)
        phi = (l2p(local, tree, cfg) if l2p_impl is None
               else l2p_impl(local, tree, cfg))
        if cfg.use_p2l_m2p:
            phi = m2p_sweep(phi, mult[cfg.nlevels], tree, conn, cfg)
        if p2p_impl is None:
            return p2p_sweep(phi, tree, conn, cfg)
        return phi + p2p_impl(tree, conn, cfg)


def with_charges(plan: FmmPlan, q: torch.Tensor) -> FmmPlan:
    """``plan`` with the charges ``q`` ((B, N), input order) in place of
    its own (which may be None): gathered by ``plan.tree.perm`` into rank
    order as ``build_tree`` gathers them (phase ``fmm::charges``). The
    tree and the lists depend on the positions alone, so ``fmm_evaluate``
    of the result is bitwise that of a plan built from the same positions
    and ``q``. On a one-problem plan ``q`` may be (K, N), K densities:
    one gather of the K rows through the one permutation, and the plan's
    geometry stays single (the density axis, module docstring)."""
    with trace.phase("fmm::charges"):
        perm = plan.tree.perm.expand(q.shape[0], -1)
        sorted_q = torch.gather(q.to(plan.tree.z.dtype), -1, perm)
    return FmmPlan(tree=plan.tree._replace(q=sorted_q), conn=plan.conn)


def unsort(phi_sorted: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Rank order -> input order (``perm`` is a permutation per row; one
    row serves every density of a (K, N) ``phi_sorted``)."""
    perm = perm.expand(phi_sorted.shape[0], -1)
    return torch.empty_like(phi_sorted).scatter_(-1, perm, phi_sorted)


def _potential(z: torch.Tensor, q: torch.Tensor, cfg: FmmConfig):
    """(phi, plan) of (N,) or (B, N) inputs, plain sweeps."""
    single = z.dim() == 1
    if single:
        z, q = z[None], q[None]
    plan = fmm_build(z, q, cfg)
    phi = unsort(fmm_evaluate(plan, cfg), plan.tree.perm)
    return (phi[0] if single else phi), plan


def fmm_potential(z: torch.Tensor, q: torch.Tensor,
                  cfg: FmmConfig) -> torch.Tensor:
    """Phi(z_i) = sum_{j != i} G(z_i, x_j) for all input points (eq. 1.1),
    plain sweeps; ``z``/``q`` (N,) or (B, N)."""
    return _potential(z, q, cfg)[0]


def fmm_potential_with_stats(z: torch.Tensor, q: torch.Tensor,
                             cfg: FmmConfig):
    """``fmm_potential`` plus the plan's ``connectivity_stats``:
    (phi, stats)."""
    phi, plan = _potential(z, q, cfg)
    return phi, connectivity_stats(plan.conn)


def fmm_potential_checked(z: torch.Tensor, q: torch.Tensor, cfg: FmmConfig,
                          max_grow: int = 3):
    """``fmm_potential`` with interaction-list overflow validation:
    (phi, the config used). Builds the plan, reads its overflow (one
    scalar to the host) and, while a list overflows, doubles
    ``strong_cap`` with ``weak_cap=0`` (-> 4 * strong_cap), at most
    ``max_grow`` times, before evaluating; then raises
    ``CapOverflowError``. ``z``/``q`` (N,) or (B, N): a batch grows to
    its worst row."""
    single = z.dim() == 1
    zb, qb = (z[None], q[None]) if single else (z, q)
    for _ in range(max_grow + 1):
        plan = fmm_build(zb, qb, cfg)
        if int(plan.conn.overflow.max()) == 0:
            phi = unsort(fmm_evaluate(plan, cfg), plan.tree.perm)
            return (phi[0] if single else phi), cfg
        cfg = dataclasses.replace(cfg, strong_cap=2 * cfg.strong_cap,
                                  weak_cap=0)
    raise CapOverflowError(
        f"interaction lists overflow even at strong_cap={cfg.strong_cap}")


def plan_from_numpy(tree_arrays, conn_arrays, cfg: FmmConfig,
                    device=None) -> FmmPlan:
    """One problem's plan handed over as numpy arrays -> a B = 1 plan on
    ``device`` (default the CUDA card, raising without one; pass
    ``device="cpu"`` for the CPU).

    ``tree_arrays``/``conn_arrays`` carry the fields of ``Tree`` and
    ``Connectivity`` (as attributes, e.g. a reference plan after
    ``jax.device_get``, or as a mapping), unbatched. Lets a test feed one
    identical topology to both packages.
    """
    device = resolve_device(device)

    def field(obj, name):
        return obj[name] if isinstance(obj, dict) else getattr(obj, name)

    def t(a, dtype=None):
        a = torch.as_tensor(np.array(a), device=device)
        return (a if dtype is None else a.to(dtype))[None]

    tree = Tree(
        perm=t(field(tree_arrays, "perm"), torch.int64),
        z=t(field(tree_arrays, "z"), cfg.torch_complex),
        q=t(field(tree_arrays, "q"), cfg.torch_complex),
        centers=tuple(t(c, cfg.torch_complex)
                      for c in field(tree_arrays, "centers")),
        radii=tuple(t(r, cfg.torch_real)
                    for r in field(tree_arrays, "radii")))
    i32 = torch.int32
    conn = Connectivity(
        strong=tuple(t(s, i32) for s in field(conn_arrays, "strong")),
        weak=tuple(t(w, i32) for w in field(conn_arrays, "weak")),
        p2p=t(field(conn_arrays, "p2p"), i32),
        p2l=t(field(conn_arrays, "p2l"), i32),
        m2p=t(field(conn_arrays, "m2p"), i32),
        overflow=t(field(conn_arrays, "overflow"), i32),
        margins=t(field(conn_arrays, "margins"), i32))
    return FmmPlan(tree=tree, conn=conn)
