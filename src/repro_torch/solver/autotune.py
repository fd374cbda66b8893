"""Workload autotuning: fit the padded-list budgets (and the tile fields).

The connectivity lists are padded to static caps (``strong_cap`` /
``weak_cap``) so every shape is fixed before any data is seen — the
paper's central design point. The caps are therefore a *performance*
parameter: too small and interactions overflow (dropped -> wrong answer,
caught by ``Connectivity.overflow``); too large and every sweep pays for
dead padding. Holm, Engblom, Goude & Holmgren (arXiv:1311.1006) make the
case that such parameters should be tuned per workload at run time.

``tune_caps`` runs the topological phase (tree + connectivity) a handful
of times on a sample of the workload:

  1. *grow*: double ``strong_cap`` until nothing overflows;
  2. *shrink*: read the actual per-box occupancy maxima from the
     overflow-free build and re-pad to ``margin`` times that, rounded up
     to ``round_to``;
  3. *verify*: one final build confirms ``overflow == 0`` at the shrunk
     caps.

Each probe builds through the topology hooks it is given
(``topology_impls``, a ``Backend.topology_impls()`` dict): ``FmmSolver.tune``
passes its backend's, so on the card the probes launch the classify
kernel (once a level), as ``apply`` does. The lists are bit-identical to the plain
path's, so the hooks cannot change a tuned cap.

The tile part (``eval_fused_vmem_bytes``, ``tile_candidates``,
``heuristic_tiles``, ``tune_tiles``) keeps the reference's formulas for
the TPU fields ``tile_boxes`` / ``stage_width``, so that ``tune`` returns
the reference's config field for field. No CUDA kernel of this package
reads either field (``core/config.py``): each owns one leaf or one box a
block, and this module adds no launch knob of its own. So ``tune_tiles``
measures nothing on any backend: it returns the lane heuristic's tile
with ``None`` seconds (the reference's "not measurable" branch), and it
refuses a ``timer``, whose sweep would pick a winner from the noise
between identical computations.

A 2-D sample ``(B, N)`` tunes one cap budget for all B problems (the
``apply_batched`` serving shape): caps are sized to the worst row.

Every entry point works on the CUDA card unless ``device="cpu"`` is
passed; the sample is moved to that device in the config's dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..core.config import FmmConfig, max_leaf_size
from ..core.fmm import fmm_build
from ..core.topology import connectivity_stats
from ..device import resolve_device


class TuneResult(NamedTuple):
    """Outcome of a tuning run (caps, and optionally tiles)."""

    cfg: FmmConfig          # tuned config (overflow-free on the sample)
    stats: dict             # connectivity stats at the tuned caps
    trials: list            # [(strong_cap, weak_cap, overflow), ...]
    tile_trials: tuple = ()  # ((tile_boxes, stage_width, seconds|None), ...)
    dispatched: tuple = ()   # (("apply", backend), ("apply_batched", ...)):
    #                          what the tuned solver runs per entry point


def _round_up(x: int, m: int) -> int:
    return max(m, (x + m - 1) // m * m)


def _sample(z, q, cfg: FmmConfig, device):
    """(z, q) as complex tensors of the config's dtype on ``device``;
    ``q=None`` -> unit charges."""
    dev = resolve_device(device)

    def put(a):
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.array(a))
        return t.to(dev, cfg.torch_complex)

    z = put(z)
    return z, (torch.ones_like(z) if q is None else put(q))


def probe_caps(z, q, cfg: FmmConfig, *, topology_impls: dict | None = None,
               device=None) -> tuple[int, dict]:
    """Build tree+connectivity once per row; return (overflow, stats).

    ``z``/``q`` may be ``(N,)`` for one problem or ``(B, N)`` for a batch
    sharing one cap budget — stats then aggregate the worst row (minimum
    margin per class, maximum of every count).
    """
    z, q = _sample(z, q, cfg, device)
    if z.dim() == 1:
        z, q = z[None], q[None]
    topo = topology_impls or {}
    overflow, stats = 0, None
    for b in range(z.shape[0]):
        plan = fmm_build(z[b:b + 1], q[b:b + 1], cfg, **topo)
        s = connectivity_stats(plan.conn)
        overflow = max(overflow, s["overflow"])
        if stats is None:
            stats = s
        else:
            stats = {k: ({c: min(stats[k][c], s[k][c]) for c in stats[k]}
                         if isinstance(stats[k], dict)
                         else max(stats[k], s[k]))
                     for k in stats}
    return overflow, stats


def tune_caps(z, q, cfg: FmmConfig, *, margin: float = 1.25,
              round_to: int = 8, max_grow: int = 6,
              topology_impls: dict | None = None,
              device=None) -> TuneResult:
    """Fit ``strong_cap``/``weak_cap`` to the sample; see module docstring.

    ``margin`` head-room (>= 1) absorbs drift between the tuning sample
    and production inputs; ``round_to`` rounds the caps up.
    """
    if margin < 1.0:
        raise ValueError("margin must be >= 1")
    z, q = _sample(z, q, cfg, device)

    def probe(c):
        return probe_caps(z, q, c, topology_impls=topology_impls,
                          device=z.device)

    trials: list = []
    cur = cfg
    for attempt in range(max_grow + 1):
        overflow, stats = probe(cur)
        trials.append((cur.strong_cap, cur.weak_cap, overflow))
        if overflow == 0:
            break
        if attempt == max_grow:
            raise RuntimeError(
                f"connectivity still overflows by {overflow} at "
                f"strong_cap={cur.strong_cap} (after {max_grow} doublings); "
                "the sample distribution defeats the theta-criterion caps")
        cur = dataclasses.replace(cur, strong_cap=2 * cur.strong_cap,
                                  weak_cap=0)  # 0 -> 4*strong (post_init)

    strong = _round_up(int(stats["strong_max"] * margin), round_to)
    weak = _round_up(int(stats["weak_max"] * margin), round_to)
    tuned = dataclasses.replace(cur, strong_cap=strong, weak_cap=weak)

    overflow, stats = probe(tuned)
    trials.append((tuned.strong_cap, tuned.weak_cap, overflow))
    if overflow != 0:  # cannot happen: caps >= measured maxima
        raise RuntimeError("tuned caps overflow; file a bug")
    return TuneResult(cfg=tuned, stats=stats, trials=trials)


# ---------------------------------------------------------------------------
# the reference's tile fields (tile_boxes / stage_width)
# ---------------------------------------------------------------------------

# The reference's budget for its fused evaluation kernel's VMEM working
# set (half of a TPU core's ~16 MB). Kept, with the formulas below, so
# the tile fields of a tuned config are the reference's.
EVAL_VMEM_BUDGET = 8 * 2**20


def eval_fused_vmem_bytes(cfg: FmmConfig, tile_boxes: int | None = None,
                          stage_width: int | None = None) -> int:
    """The reference's VMEM working-set estimate of its fused evaluation
    kernel at this tiling: 5 (TB, n_pad) target planes, 2 (TB, P) local
    blocks and 2 (TB, n_pad) phi blocks resident; TB*SW staged source
    rows of 5 particle and 2 multipole planes plus 3 (TB, SW) slot
    planes, double-buffered. Batch-invariant."""
    TB = cfg.tile_boxes if tile_boxes is None else tile_boxes
    SW = cfg.stage_width if stage_width is None else stage_width
    n_pad = -(-max_leaf_size(cfg) // 128) * 128
    P = -(-(cfg.p + 1) // 128) * 128
    itemsize = 8 if cfg.dtype == "f64" else 4
    resident = TB * (7 * n_pad + 2 * P)
    staged = TB * SW * (5 * n_pad + 2 * P) + 3 * TB * SW
    return (resident + 2 * staged) * itemsize


def tile_candidates(cfg: FmmConfig,
                    vmem_budget: int = EVAL_VMEM_BUDGET) -> list[int]:
    """Pow-2 ``tile_boxes`` candidates up to the leaf-level box count
    whose ``eval_fused_vmem_bytes`` fits the budget."""
    cands = [t for t in (1, 2, 4, 8, 16) if t <= cfg.nboxes] or [1]
    fit = [t for t in cands
           if eval_fused_vmem_bytes(cfg, tile_boxes=t) <= vmem_budget]
    return fit or cands[:1]


def heuristic_tiles(cfg: FmmConfig) -> FmmConfig:
    """The reference's lane-geometry default: the largest candidate tile
    <= 8, one staged slot."""
    tb = max(t for t in tile_candidates(cfg) if t <= 8)
    return dataclasses.replace(cfg, tile_boxes=tb, stage_width=1)


def tune_tiles(z, q, cfg: FmmConfig, *, backend: str = "auto",
               timer: Optional[Callable] = None,
               device=None) -> tuple[FmmConfig, list]:
    """Pick ``tile_boxes``/``stage_width`` for this workload: the
    reference's "not measurable" branch on every backend, the lane
    heuristic's tile with trials ``[(tile_boxes, stage_width, None)]``.

    The arguments keep the reference's signature. A ``timer`` raises
    ``NotImplementedError``: no CUDA kernel reads either field, so a
    sweep would time identical computations.
    """
    if timer is not None:
        raise NotImplementedError("no CUDA kernel reads tile_boxes/"
                                  "stage_width, so there is no tile to "
                                  "time")
    tuned = heuristic_tiles(cfg)
    return tuned, [(tuned.tile_boxes, tuned.stage_width, None)]
