"""`FmmSolver` — the front-end over the FMM pipeline.

    solver = FmmSolver.build(cfg)            # cached per (cfg, backend, device)
    phi = solver.apply(z, q)                 # one problem, (N,) -> (N,)
    phib = solver.apply_batched(zb, qb)      # (B, N) -> (B, N)

Time-stepping callers (vortex methods: the particles move a little each
step and the topology is rebuilt every step) split ``apply`` at the
topology/evaluation seam:

    plan = solver.refresh(z, q)              # tree + connectivity only
    phi = solver.apply_plan(plan)            # upward/downward/evaluation

``refresh`` + ``apply_plan`` runs exactly the calls of ``apply``, in
its order, so their phi is bitwise ``apply``'s; in between the caller
can read ``plan.conn.overflow`` or ``stats`` without a second build.

Callers whose positions never move and whose charges change every call
(the matvec of an iterative boundary-integral solve) keep one plan and
evaluate new charges on it:

    phi = solver.apply_charges(plan, q)      # bitwise apply(z, q)
    phis = solver.apply_charges(plan, qs)    # (K, N): K densities at once

The topology depends on the positions alone, so this is ``apply``'s phi
bit for bit; its program holds the plan (``solver.program``) and copies
only ``q`` on each replay. A block solver (one density a right-hand
side) hands K <= ``MAX_DENSITIES`` densities to one call: the plan's
tree, lists and geometry are read once for all of them (the density
axis of ``core.fmm``), and row k is ``apply_charges(plan, qs[k])``
within rounding.

Each entry point runs as a compiled program, one per problem shape
(``solver.program``): on the card the first call at a shape (B, dtype)
runs the pipeline eagerly, the second captures it as a CUDA graph and
replays it, and every later call replays it; a replay returns fresh
tensors, never a graph buffer. On the CPU the same programs run the
pipeline eagerly. ``_compiled_program_count()`` counts a solver's
programs, and ``_release_executables()`` drops them (graphs, static
buffers, memory pool); LRU eviction, ``cache_clear`` and the programs'
memory budget (``program.program_budget``) release them, and a released
solver captures again at its second call at a shape.

The solver runs on ``cuda`` unless the caller passes ``device="cpu"``;
on a machine without a CUDA card the default raises instead of falling
back to the CPU. With the "cuda" backend each of the four kernels of the
main path runs exactly once per ``apply`` — and once per
``apply_batched``, whatever B: every kernel grid carries the problems as
an explicit axis — but classify, which launches once a tree level.
``refresh`` launches the classify kernel (once a level), and
``apply_plan`` the M2L, P2L and fused evaluation kernels.

``apply_with_health``/``apply_checked`` return or check the health plane
(cap margins, overflow, non-finite flags) computed beside phi.

    solver = solver.tune(z_sample)           # fit the list caps
    guarded = solver.guarded()               # the recovery ladder
    phi, report = guarded.apply_guarded(z, q)
"""
from __future__ import annotations

import copy
import warnings
from collections import OrderedDict
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import trace
from ..core import fmm as _fmm
from ..core.config import FmmConfig
from ..core.fmm import (HEALTH_CLASSES, FmmPlan, Health, fmm_build,
                        fmm_evaluate, health_of, m2l_mat, unsort,
                        with_charges)
from ..core.topology import connectivity_stats, leaf_layout
from ..core.topology.tree import split_tables
from ..device import resolve_device
from ..errors import (BackendDowngradeWarning, CapOverflowError, DTypeError,
                      NonFiniteInputError, NonFiniteOutputError, ShapeError)
from .autotune import TuneResult, tune_caps, tune_tiles
from .backends import Backend, get_backend
from .program import ProgramSet

# LRU of solvers, keyed by (cfg, resolved backend name, device), so
# "auto" shares the entry of whatever backend it resolves to. Eviction
# (and cache_clear) releases a solver's programs, so they cannot strand
# device memory; an evicted solver stays usable by whoever holds it and
# captures again at its second call at a shape. The programs' graph
# pools are bounded in bytes apart from this count (``solver.program``).
# Hit/miss/eviction traffic is read with ``FmmSolver.cache_info()``.
_CACHE: OrderedDict = OrderedDict()
#: Densities one ``apply_charges`` call evaluates on a one-problem plan.
MAX_DENSITIES = 16
_CACHE_MAX = 64
_CACHE_STATS = {"hits": 0, "misses": 0, "evictions": 0}


class CacheInfo(NamedTuple):
    """``FmmSolver.cache_info()`` snapshot (the functools.lru_cache idiom)."""

    hits: int
    misses: int
    maxsize: int
    currsize: int
    evictions: int


def host_health(health: Health) -> dict:
    """The health plane on the host, reduced over the batch axis: margins
    min per class, overflow max, non-finite flags any."""
    margins = health.margins.cpu().numpy().reshape(-1, len(HEALTH_CLASSES))
    return {
        "margins": {c: int(m) for c, m in
                    zip(HEALTH_CLASSES, margins.min(axis=0))},
        "overflow": int(health.overflow.max()),
        "nonfinite_input": bool(health.nonfinite_input.any()),
        "nonfinite_output": bool(health.nonfinite_output.any()),
    }


def raise_unhealthy(h: dict, cfg: FmmConfig, entry: str = "apply") -> None:
    """Raise the typed error matching a ``host_health`` dict (no-op when
    healthy): garbage input first, then dropped interactions, then
    non-finite output."""
    if h["nonfinite_input"]:
        raise NonFiniteInputError(
            f"{entry}: z or q contain NaN/Inf — refusing to compute on "
            "non-finite input")
    if h["overflow"]:
        neg = {c: m for c, m in h["margins"].items() if m < 0}
        raise CapOverflowError(
            f"{entry}: connectivity caps overflow by {h['overflow']} "
            f"(strong_cap={cfg.strong_cap}, weak_cap={cfg.weak_cap}; "
            f"negative margins {neg}); raise the caps for this workload",
            margins=h["margins"], overflow=h["overflow"])
    if h["nonfinite_output"]:
        raise NonFiniteOutputError(
            f"{entry}: phi contains NaN/Inf on finite input — kernel or "
            "expansion fault")


#: The halves of the pipeline each entry point's program runs.
ENTRIES = {"apply": ("build", "evaluate"),
           "apply_batched": ("build", "evaluate"),
           "apply_with_health": ("build", "evaluate"),
           "apply_batched_with_health": ("build", "evaluate"),
           "refresh": ("build",),
           "apply_plan": ("evaluate",),
           "apply_charges": ("evaluate",)}


class FmmSolver:
    """FMM evaluator for one ``FmmConfig``, backend and device. Prefer
    ``FmmSolver.build``, which returns the cached instance.

    ``trace_counts`` counts, per half of the pipeline ("build": tree and
    connectivity; "evaluate": upward, downward, evaluation), the problem
    shapes (B, dtype, device) this solver has prepared that half for:
    the first program at a new shape builds the device constants the
    half reads (the static leaf layout and split tables; the M2L matrix)
    and later programs at that shape reuse them. This is the port's
    counterpart of the reference's trace count: a steady-shape
    time-stepping loop reads ``{"build": 1, "evaluate": 1}`` and a new B
    raises both. Calls are not counted. One departure: a release keeps
    the constants, so programs made again after
    ``_release_executables`` count nothing, where the reference's
    ``refresh`` and ``apply_plan`` trace again after ``clear_cache`` and
    raise its counts by one each.
    """

    def __init__(self, cfg: FmmConfig, backend: str = "auto", device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.backend_name = backend
        self.backend: Backend = get_backend(backend, self.device)
        if not self.backend.supports(cfg):
            raise NotImplementedError(
                f"backend {self.backend.name!r} does not support "
                f"kernel={cfg.kernel!r}")
        self._impls = self.backend.phase_impls()
        self._topo = self.backend.topology_impls()
        # The batched-dispatch contract (``solver.backends``): "native"
        # and "vmap" backends serve batches through their own hooks; a
        # "fallback" backend's batches go through the reference hooks.
        if self.backend.batched_dispatch == "fallback":
            ref = get_backend("reference", self.device)
            self._batched_impls = ref.phase_impls()
            self._batched_topo = ref.topology_impls()
            batched_name = ref.name
        else:
            self._batched_impls, self._batched_topo = self._impls, self._topo
            batched_name = self.backend.name
        # What each entry point actually runs, so timings cannot be
        # attributed to the wrong backend.
        self.dispatched = {"apply": self.backend.name,
                           "apply_batched": batched_name}
        self._warned_batched_fallback = False
        self.trace_counts = {"build": 0, "evaluate": 0}
        self._prepared: dict = {}
        self._programs = ProgramSet()
        self.tune_result: Optional[TuneResult] = None

    # -- construction -------------------------------------------------------

    @classmethod
    def build(cls, cfg: FmmConfig, backend: str = "auto",
              device=None) -> "FmmSolver":
        """Cached constructor: one solver per ``(cfg, resolved backend,
        device)``."""
        dev = resolve_device(device)
        key = (cfg, get_backend(backend, dev).name, str(dev))
        solver = _CACHE.get(key)
        if solver is None:
            _CACHE_STATS["misses"] += 1
            solver = _CACHE[key] = cls(cfg, backend, dev)
            while len(_CACHE) > _CACHE_MAX:
                _, evicted = _CACHE.popitem(last=False)
                _CACHE_STATS["evictions"] += 1
                evicted._release_executables()
        else:
            _CACHE_STATS["hits"] += 1
            _CACHE.move_to_end(key)
        return solver

    @classmethod
    def cache_clear(cls) -> None:
        for solver in _CACHE.values():
            solver._release_executables()
        _CACHE.clear()
        _CACHE_STATS.update(hits=0, misses=0, evictions=0)

    def _release_executables(self) -> None:
        """Drop this solver's programs (every entry point, health twins
        included): graphs, static buffers and memory pool; the memory
        goes back to the caching allocator (``torch.cuda.empty_cache()``
        then returns it to the card). The device constants stay. The
        solver stays usable: its next call at a shape runs eagerly and
        the one after captures again."""
        self._programs.release()

    def _compiled_program_count(self) -> int:
        """How many programs this solver holds (one per entry point and
        problem shape)."""
        return len(self._programs)

    def programs(self) -> dict:
        """This solver's programs by key ``(entry, B, dtype, device)``
        (B is ``(1, K)`` for ``apply_charges`` of K > 1 densities):
        each with the host launches of its first run (``launches``), the
        launches its capture recorded (``recorded``), its ``calls`` and
        its graph ``replays``."""
        return self._programs.items()

    @classmethod
    def cache_size(cls) -> int:
        return len(_CACHE)

    @classmethod
    def _cached_solvers(cls) -> list:
        """The solvers in the ``build`` cache, least recent first."""
        return list(_CACHE.values())

    @classmethod
    def cache_info(cls) -> CacheInfo:
        """Hit/miss/eviction counters of the ``build`` cache."""
        return CacheInfo(hits=_CACHE_STATS["hits"],
                         misses=_CACHE_STATS["misses"],
                         maxsize=_CACHE_MAX, currsize=len(_CACHE),
                         evictions=_CACHE_STATS["evictions"])

    # -- the pipeline -------------------------------------------------------

    def _prepare(self, half: str, t: torch.Tensor) -> tuple:
        """The device constants of ``half`` ("build" or "evaluate") at the
        shape of ``t`` (B, dtype, device), built and counted in
        ``trace_counts`` the first time and held for this solver's life,
        so the pipeline's constant caches always find them."""
        key = (half, t.shape[0], t.dtype, t.device)
        if key not in self._prepared:
            cfg = self.cfg
            lay = leaf_layout(cfg.n, cfg.nlevels, t.device)
            self._prepared[key] = (
                (lay, split_tables(cfg.n, cfg.nlevels, t.device))
                if half == "build" else
                (lay, m2l_mat(cfg.p, cfg.torch_real, t.device)))
            self.trace_counts[half] += 1
        return self._prepared[key]

    def _pipeline(self, entry: str):
        """The function the program of ``entry`` runs. It binds the
        connectivity builder of ``core.fmm`` as it is now, so a program
        runs what existed when it was made (a capture freezes it on the
        card)."""
        cfg = self.cfg
        connect = _fmm.build_connectivity
        if "batched" in entry:
            impls, topo = self._batched_impls, self._batched_topo
        else:
            impls, topo = self._impls, self._topo

        def build(z, q) -> FmmPlan:
            return fmm_build(z, q, cfg, connect=connect, **topo)

        def evaluate(plan: FmmPlan) -> torch.Tensor:
            phi = fmm_evaluate(plan, cfg, **impls)
            with trace.phase("fmm::unsort"):
                return unsort(phi, plan.tree.perm)

        if entry == "refresh":
            return build
        if entry == "apply_plan":
            return evaluate
        if entry == "apply_charges":
            return lambda plan, q: evaluate(with_charges(plan, q))
        with_health = entry.endswith("with_health")

        def core(z, q):
            plan = build(z, q)
            phi = evaluate(plan)
            if with_health:
                with trace.phase("fmm::health"):
                    return phi, health_of(plan, z, q, phi)
            return phi

        return core

    def _run(self, entry: str, *args, held: int = 0,
             densities: Optional[int] = None):
        """``entry``'s program at the shape of ``args`` (made at the first
        call, with the device constants it reads, holding the first
        ``held`` arguments: ``solver.program``; ``densities`` K on one
        geometry, a program of its own for each K > 1) run on ``args``:
        (B, N) phi in input order, (phi, Health) or a plan."""
        t = args[0] if isinstance(args[0], torch.Tensor) else args[0].tree.z
        B = t.shape[0] if (densities or 1) == 1 else (t.shape[0], densities)
        key = (entry, B, t.dtype, t.device)

        def make():
            for half in ENTRIES[entry]:
                self._prepare(half, t)
            return self._pipeline(entry)

        return self._programs.program(key, make, args, held,
                                      densities)(*args)

    def _to_device(self, a) -> torch.Tensor:
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.array(a))
        return t.to(self.device, self.cfg.torch_complex)

    # -- evaluation ---------------------------------------------------------

    def apply(self, z, q) -> torch.Tensor:
        """phi_i = sum_{j != i} G(z_i, x_j) for one problem; input order.

        Trusts the caps: an input whose interaction lists exceed
        ``strong_cap``/``weak_cap`` silently drops interactions — use
        ``apply_checked`` where inputs may drift (or monitor ``stats``)."""
        self._validate(z, q, "apply")
        return self._run("apply", self._to_device(z)[None],
                         self._to_device(q)[None])[0]

    def apply_with_health(self, z, q):
        """``apply`` plus the health plane: ``(phi, Health)`` with the
        batch axis of the health fields kept (B = 1)."""
        self._validate(z, q, "apply_with_health")
        phi, health = self._run("apply_with_health",
                                self._to_device(z)[None],
                                self._to_device(q)[None])
        return phi[0], health

    def apply_checked(self, z, q) -> torch.Tensor:
        """``apply`` that raises the typed errors of ``repro_torch.errors``
        (``CapOverflowError``, ``NonFiniteInputError``,
        ``NonFiniteOutputError``) instead of returning a wrong answer."""
        phi, health = self.apply_with_health(z, q)
        raise_unhealthy(host_health(health), self.cfg, "apply_checked")
        return phi

    def apply_batched(self, z, q) -> torch.Tensor:
        """B independent problems of this config in one call: (B, N) ->
        (B, N), each row in its input order. One launch per kernel for
        the whole batch on a "native" backend; a "fallback" backend's
        batch runs the reference hooks (``dispatched["apply_batched"]``,
        warned once per solver)."""
        self._validate_batched(z, q)
        self._warn_batched_fallback()
        return self._run("apply_batched", self._to_device(z),
                         self._to_device(q))

    def apply_batched_with_health(self, z, q):
        """``apply_batched`` plus the per-row health plane."""
        self._validate_batched(z, q)
        self._warn_batched_fallback()
        return self._run("apply_batched_with_health", self._to_device(z),
                         self._to_device(q))

    def apply_batched_checked(self, z, q) -> torch.Tensor:
        """``apply_batched`` that raises when any row is unhealthy."""
        phi, health = self.apply_batched_with_health(z, q)
        raise_unhealthy(host_health(health), self.cfg,
                        "apply_batched_checked")
        return phi

    def _warn_batched_fallback(self) -> None:
        if (self.dispatched["apply_batched"] != self.backend.name
                and not self._warned_batched_fallback):
            self._warned_batched_fallback = True
            warnings.warn(
                f"backend {self.backend.name!r} declares "
                "batched_dispatch='fallback': apply_batched dispatches "
                f"the {self.dispatched['apply_batched']!r} hooks instead "
                "(same answer; do not attribute batched timings to "
                f"{self.backend.name!r})", BackendDowngradeWarning,
                stacklevel=3)

    # -- the topology/evaluation seam ---------------------------------------

    def refresh(self, z, q) -> FmmPlan:
        """Rebuild tree + connectivity for one problem's (moved)
        particles: the B = 1 plan of ``fmm_build`` with this backend's
        topology hook (on "cuda": one classify launch a level). Feed it to
        ``apply_plan``; ``plan.conn.overflow`` (one scalar) monitors cap
        drift as the particles move."""
        self._validate(z, q, "refresh")
        return self._run("refresh", self._to_device(z)[None],
                         self._to_device(q)[None])

    def apply_plan(self, plan: FmmPlan) -> torch.Tensor:
        """Evaluate a built plan (from ``refresh``) with this backend's
        phase hooks, in input order: (N,) for a B = 1 plan, (B, N) for a
        plan of B problems. ``refresh`` + ``apply_plan`` is ``apply``
        split at the topology/evaluation seam. On the card the plan
        (from ``refresh`` or ``plan_from_numpy``) is copied into the
        program's buffers; a plan of other shapes than the program's
        (other caps) raises ``ShapeError``."""
        zs = tuple(plan.tree.z.shape)
        if len(zs) != 2 or zs[-1] != self.cfg.n:
            raise ShapeError(f"apply_plan wants a plan of (B, {self.cfg.n})"
                             f" particles; got {zs}")
        phi = self._run("apply_plan", plan)
        return phi[0] if zs[0] == 1 else phi

    def apply_charges(self, plan: FmmPlan, q) -> torch.Tensor:
        """Evaluate new charges ``q`` on a built plan (from ``refresh`` or
        ``plan``), in input order: ``q`` and phi of shape (N,) for a B = 1
        plan, (B, N) for a plan of B problems. ``q`` is gathered into the
        tree's order (phase ``fmm::charges``), then the plan is evaluated
        as ``apply_plan`` evaluates it; phi is bitwise ``apply(z, q)``'s.
        On a B = 1 plan ``q`` may also be (K, N), K densities on its one
        geometry (1 <= K <= ``MAX_DENSITIES``): phi is (K, N), its row k
        ``apply_charges(plan, q[k])`` within rounding, from one program
        a K that reads the plan's tree, lists and geometry once. The
        counter ``fmm.densities`` adds the rows each call evaluates.
        The program holds the plan: a call with the plan of the last call
        copies only ``q`` on the card, a call with another plan of the
        same shapes binds it once (``program.plan_bind``). A plan of
        another config (N, depth, caps or dtype), or ``q`` of another
        shape (K = 0, K > ``MAX_DENSITIES``, three axes, K rows on a plan
        of B > 1 problems), raises ``ShapeError``."""
        cfg = self.cfg
        zs = tuple(plan.tree.z.shape)
        conn = plan.conn
        if (len(zs) != 2 or zs[-1] != cfg.n
                or plan.tree.z.dtype != cfg.torch_complex
                or len(plan.tree.centers) != cfg.nlevels + 1
                or conn.p2p.shape[-1] != cfg.strong_cap
                or conn.weak[-1].shape[-1] != cfg.weak_cap):
            raise ShapeError(
                f"apply_charges wants a plan of this config ({zs[-1:]} -> "
                f"N={cfg.n}, nlevels={cfg.nlevels}, caps "
                f"{cfg.strong_cap}/{cfg.weak_cap}, {cfg.dtype}); got "
                f"particles {zs} {plan.tree.z.dtype}, "
                f"{len(plan.tree.centers) - 1} levels, caps "
                f"{conn.p2p.shape[-1]}/{conn.weak[-1].shape[-1]}")
        qs = tuple(getattr(q, "shape", ()))
        single = zs[0] == 1 and qs == (cfg.n,)
        block = (zs[0] == 1 and len(qs) == 2 and qs[-1] == cfg.n
                 and 1 <= qs[0] <= MAX_DENSITIES)
        if not (single or block or qs == zs):
            want = ((f"({cfg.n},) or (K, {cfg.n}) with 1 <= K <= "
                     f"{MAX_DENSITIES}") if zs[0] == 1 else f"{zs}")
            raise ShapeError(f"apply_charges wants q of shape {want} for a "
                             f"plan of {zs}; got {qs}")
        self._validate_dtypes("apply_charges", q=q)
        qd = self._to_device(q).reshape(-1, cfg.n)
        trace.count("fmm.densities", qd.shape[0])
        # the program holds the plan without its charges: it reads no others
        bare = FmmPlan(plan.tree._replace(q=None), conn)
        phi = self._run("apply_charges", bare, qd, held=1,
                        densities=qd.shape[0] if block else 1)
        return phi[0] if single else phi

    def plan(self, z, q) -> FmmPlan:
        """Topological phase only (tree + connectivity), for inspection."""
        return self.refresh(z, q)

    def stats(self, z, q) -> dict:
        """Connectivity stats (incl. ``overflow``) for one problem."""
        return connectivity_stats(self.plan(z, q).conn)

    def guarded(self, **kwargs) -> "GuardedSolver":  # noqa: F821
        """This solver's config, backend and device behind the recovery
        ladder (``repro_torch.solver.guard.GuardedSolver``); keyword
        arguments go to ``GuardedSolver``."""
        from .guard import GuardedSolver  # local: guard imports solver
        return GuardedSolver(self.cfg, self.backend_name, device=self.device,
                             **kwargs)

    # -- autotuning ---------------------------------------------------------

    def tune(self, z_sample, q_sample=None, *, margin: float = 1.25,
             round_to: int = 8, max_grow: int = 6, tiles: bool = True,
             tile_timer=None) -> "FmmSolver":
        """Fit ``strong_cap``/``weak_cap`` (and the reference's tile
        fields) to a workload sample on this solver's device, probing
        through its backend's topology hook (on "cuda": the classify
        kernel, one launch a level, probe and row).

        ``z_sample`` may be (N,) or (B, N) — a batch tunes the shared cap
        budget to its worst row. With ``tiles=True`` the tile fields are
        set at the tuned caps to the reference's heuristic
        (``autotune.tune_tiles``); a ``tile_timer`` raises
        ``NotImplementedError``, since no CUDA kernel reads those fields.
        Returns a copy of the cached solver for the tuned config with
        ``tune_result`` attached.
        """
        result = tune_caps(z_sample, q_sample, self.cfg, margin=margin,
                           round_to=round_to, max_grow=max_grow,
                           topology_impls=self._topo, device=self.device)
        if tiles:
            tiled_cfg, tile_trials = tune_tiles(
                z_sample, q_sample, result.cfg, backend=self.backend_name,
                timer=tile_timer, device=self.device)
            result = result._replace(cfg=tiled_cfg,
                                     tile_trials=tuple(tile_trials))
        # Shallow copy: shares the cached solver's programs and prepared
        # constants but carries this caller's tune_result.
        tuned = copy.copy(FmmSolver.build(result.cfg, self.backend_name,
                                          self.device))
        result = result._replace(
            dispatched=tuple(sorted(tuned.dispatched.items())))
        tuned.tune_result = result
        return tuned

    # -- argument validation (typed errors, repro_torch.errors) ------------

    def _validate_dtypes(self, entry: str, **arrays) -> None:
        want = np.dtype(self.cfg.complex_dtype)
        for name, a in arrays.items():
            if isinstance(a, torch.Tensor):
                if not a.is_complex():
                    raise DTypeError(
                        f"{entry} wants complex {name}; got real {a.dtype}"
                        " — pass a complex tensor (positions z = x + iy)")
                size = a.element_size()
            else:
                dt = np.asarray(a).dtype
                if not np.issubdtype(dt, np.complexfloating):
                    raise DTypeError(
                        f"{entry} wants complex {name}; got real {dt.name}")
                size = dt.itemsize
            if size < want.itemsize:
                raise DTypeError(
                    f"{entry}: {name} is narrower than the configured "
                    f"dtype={self.cfg.dtype!r}; cast it to {want.name}")

    def _validate(self, z, q, entry: str) -> None:
        n = self.cfg.n
        zs, qs = tuple(getattr(z, "shape", ())), tuple(getattr(q, "shape", ()))
        if zs != (n,) or qs != (n,):
            raise ShapeError(
                f"{entry} wants z and q of shape ({n},); got z{zs} q{qs}")
        self._validate_dtypes(entry, z=z, q=q)

    def _validate_batched(self, z, q) -> None:
        zs, qs = tuple(getattr(z, "shape", ())), tuple(getattr(q, "shape", ()))
        if len(zs) != 2:
            raise ShapeError(f"apply_batched wants (B, N); got {zs}")
        if zs[-1] != self.cfg.n:
            raise ShapeError(f"N={zs[-1]} != cfg.n={self.cfg.n}")
        if qs != zs:
            raise ShapeError(f"apply_batched wants q of shape {zs}; got {qs}")
        self._validate_dtypes("apply_batched", z=z, q=q)
