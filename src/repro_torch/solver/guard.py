"""Guarded execution: detect → recover → degrade, never silently corrupt.

The paper's adaptive discretization is only correct while the
connectivity caps hold; production inputs drift (time-stepping advects
particles, serving traffic changes distribution), and a drifted input
silently drops interactions on the trusting ``apply``. This module is
the robustness layer over ``FmmSolver``:

  detect    the health plane (``core.fmm.Health``) computed beside phi:
            per-class cap margins + non-finite flags, read on the host
            once per rung — no second topology build
  recover   ``apply_guarded`` escalates through a bounded lattice of
            neighbouring plans: per-class cap doubling (the margins say
            *which* cap to grow), at most ``max_cap_doublings`` times;
            the ``FmmSolver.build`` cache is the lattice
  degrade   a non-finite output on finite input degrades per phase:
            first the evaluation-phase and upward hooks drop to the
            plain torch sweeps (topology and M2L keep their kernels),
            then the whole
            "reference" backend; the final rung is the O(N^2)
            ``core.direct`` summation, which cannot drop interactions
            and has no caps to overflow
  report    every attempt is recorded in a ``GuardReport`` (rungs
            walked, margins seen, retries, degradations, final backend),
            and failures raise the typed errors of ``repro_torch.errors``

The guard changes rung only on what the health plane reports: overflow,
or a non-finite input or output. It catches no exception: a kernel that
fails to build, load or launch raises out of ``apply_guarded`` as it
would out of ``apply``. Every rung runs on the guarded solver's device;
the degrade and direct rungs run plain torch there, and their attempts'
notes say so. On a CUDA device each of those rungs also warns
(``BackendDowngradeWarning``, naming the rung that failed and why): the
answer is right, but it did not come from the kernels asked for.
"""
from __future__ import annotations

import contextlib
import dataclasses
import warnings
from typing import Callable, ContextManager, Optional

import torch

from .. import trace
from ..core.config import FmmConfig
from ..core.direct import direct_potential
from ..core.fmm import HEALTH_CLASSES, FmmPlan
from ..device import resolve_device
from ..errors import (BackendDowngradeWarning, CapOverflowError,
                      NonFiniteInputError, RecoveryExhaustedError)
from .backends import Backend, get_backend, register_backend
from .solver import FmmSolver, host_health

#: Interaction-list classes whose padded width is ``strong_cap``.
_STRONG_CLASSES = ("strong", "p2p", "p2l", "m2p")


@dataclasses.dataclass(frozen=True)
class GuardAttempt:
    """One rung of a ladder walk: what ran and what the health plane saw."""

    rung: str                  # "primary" | "caps*S/W" | "degrade:*" | "direct"
    backend: str
    strong_cap: int
    weak_cap: int
    ok: bool
    overflow: int = 0
    margins: Optional[dict] = None          # HEALTH_CLASSES -> slots left
    nonfinite_input: bool = False
    nonfinite_output: bool = False
    note: str = ""


@dataclasses.dataclass(frozen=True)
class GuardReport:
    """Structured record of one guarded call.

    ``attempts`` is the full walk in order; ``retries`` counts the extra
    attempts beyond the primary; ``degradations`` the backend-degrading
    rungs taken. ``ok`` means the returned phi is trustworthy: computed
    with zero dropped interactions and finite throughout.
    """

    entry: str                                # "apply" | "apply_batched" | ...
    attempts: tuple[GuardAttempt, ...]
    final_backend: Optional[str] = None
    final_rung: Optional[str] = None

    @property
    def ok(self) -> bool:
        return bool(self.attempts) and self.attempts[-1].ok

    @property
    def retries(self) -> int:
        return max(0, len(self.attempts) - 1)

    @property
    def degradations(self) -> tuple[str, ...]:
        return tuple(a.rung for a in self.attempts
                     if a.rung.startswith("degrade:") or a.rung == "direct")

    @property
    def margins(self) -> Optional[dict]:
        return self.attempts[-1].margins if self.attempts else None

    def summary(self) -> str:
        path = " -> ".join(a.rung for a in self.attempts) or "(empty)"
        state = "ok" if self.ok else "FAILED"
        return (f"[guard:{self.entry}] {path} ({state}, "
                f"backend={self.final_backend}, retries={self.retries})")


def grow_caps(cfg: FmmConfig, margins: Optional[dict] = None) -> FmmConfig:
    """One cap-escalation step, targeted by the per-class margins: only
    the cap families that overflowed double (``strong_cap`` backs the
    strong/p2p/p2l/m2p lists, ``weak_cap`` the M2L lists). The weak cap
    is clamped to its structural bound ``4*strong_cap`` (weak candidates
    are children of the parent's strong set). With no margins, both caps
    double."""
    need_strong = (margins is None
                   or any(margins.get(c, 0) < 0 for c in _STRONG_CLASSES))
    need_weak = margins is None or margins.get("weak", 0) < 0
    strong = cfg.strong_cap * 2 if need_strong else cfg.strong_cap
    weak = cfg.weak_cap * 2 if need_weak else cfg.weak_cap
    return dataclasses.replace(cfg, strong_cap=strong,
                               weak_cap=min(weak, 4 * strong))


def degraded_eval_backend(be: Backend) -> Optional[Backend]:
    """The per-phase degradation rung: ``be`` with its evaluation-phase
    hooks (fused evaluation, P2P, L2P, downward P2L) and its upward hook
    (a NaN in the multipoles reaches every output) dropped to the plain
    torch sweeps, keeping the topology and M2L hooks (on "cuda": classify
    and M2L still launch their kernels). Registered under
    ``"<name>+ref-eval"`` so ``FmmSolver.build`` caches it like any
    backend. None if ``be`` has nothing to degrade."""
    if (be.eval_fused is None and be.p2p is None and be.l2p is None
            and be.p2l is None and be.upward is None):
        return None
    name = f"{be.name}+ref-eval"
    degraded = dataclasses.replace(be, name=name, eval_fused=None,
                                   p2p=None, l2p=None, p2l=None, upward=None)
    return register_backend(degraded)


class GuardedSolver:
    """``FmmSolver`` behind the recovery ladder (module docstring).

    The guarded entry points return ``(result, GuardReport)``. A
    successful cap escalation *promotes* the escalated solver to be the
    new primary (``self.solver``), so a time-stepping loop that drifted
    past its tuned caps re-plans once and stays on the fast path.

      guarded = GuardedSolver(cfg)                   # the CUDA card
      phi, report = guarded.apply_guarded(z, q)
      plan, report = guarded.refresh_guarded(z, q)   # time-stepping
      phi = guarded.apply_plan(plan)

    ``max_cap_doublings`` bounds the retries of the cap rung;
    ``degrade``/``direct`` gate the backend-degradation and O(N^2)
    last-resort rungs. ``device`` (default: the CUDA card) is where every
    rung runs. ``rung_hook(rung)``, if given, returns a context manager
    that is entered around each rung's run and health read (per-rung
    timing or launch counts); it changes nothing in the result.
    """

    def __init__(self, cfg: FmmConfig, backend: str = "auto", *,
                 max_cap_doublings: int = 3, degrade: bool = True,
                 direct: bool = True, device=None,
                 rung_hook: Optional[Callable[[str], ContextManager]] = None):
        if max_cap_doublings < 0:
            raise ValueError("max_cap_doublings must be >= 0")
        self.backend_name = backend
        self.device = resolve_device(device)
        self.max_cap_doublings = max_cap_doublings
        self.allow_degrade = degrade
        self.allow_direct = direct
        self.rung_hook = rung_hook or (lambda rung: contextlib.nullcontext())
        self.solver = self._build(cfg, backend)

    def _build(self, cfg: FmmConfig, backend: str) -> FmmSolver:
        return FmmSolver.build(cfg, backend, self.device)

    @property
    def cfg(self) -> FmmConfig:
        """Config of the *current* primary (escalations promote)."""
        return self.solver.cfg

    @property
    def trace_counts(self) -> dict:
        return self.solver.trace_counts

    def apply_plan(self, plan: FmmPlan) -> torch.Tensor:
        return self.solver.apply_plan(plan)

    # -- ladder machinery ---------------------------------------------------

    def _attempt(self, solver: FmmSolver, z, q, rung: str, attempts: list,
                 batched: bool, note: str = ""):
        """Run one rung's apply with its health plane; record the result."""
        with self.rung_hook(rung):
            if batched:
                phi, health = solver.apply_batched_with_health(z, q)
            else:
                phi, health = solver.apply_with_health(z, q)
            with trace.span("guard::read"):
                h = host_health(health)
        ok = not (h["overflow"] or h["nonfinite_input"]
                  or h["nonfinite_output"])
        attempts.append(GuardAttempt(
            rung=rung, backend=solver.dispatched["apply"],
            strong_cap=solver.cfg.strong_cap, weak_cap=solver.cfg.weak_cap,
            ok=ok, overflow=h["overflow"], margins=h["margins"],
            nonfinite_input=h["nonfinite_input"],
            nonfinite_output=h["nonfinite_output"], note=note))
        return phi, h, ok

    def _report(self, entry: str, attempts: list) -> GuardReport:
        last = attempts[-1] if attempts else None
        return GuardReport(entry=entry, attempts=tuple(attempts),
                           final_backend=last.backend if last else None,
                           final_rung=last.rung if last else None)

    def _direct_rung(self, z, q, attempts: list, batched: bool):
        """Last resort: the O(N^2) direct summation (plain torch on this
        solver's device, one row at a time) — no caps to overflow, no
        expansions to go non-finite on finite input."""
        kernel = self.solver.cfg.kernel
        with self.rung_hook("direct"):
            z, q = self.solver._to_device(z), self.solver._to_device(q)
            if batched:
                phi = torch.stack([direct_potential(zi, zi, qi,
                                                    kernel=kernel)
                                   for zi, qi in zip(z, q)])
            else:
                phi = direct_potential(z, z, q, kernel=kernel)
            finite = bool(torch.isfinite(phi).all())
        attempts.append(GuardAttempt(
            rung="direct", backend="direct",
            strong_cap=self.solver.cfg.strong_cap,
            weak_cap=self.solver.cfg.weak_cap, ok=finite,
            nonfinite_output=not finite,
            note=f"O(N^2) plain torch summation on {self.device} "
                 "(exact, capless)"))
        return phi, finite

    def _warn_plain(self, entry: str, rung: str, failed: GuardAttempt):
        """On a CUDA device, warn that ``rung`` serves the answer from
        plain torch sweeps in place of the kernels of ``failed``'s
        backend, and why."""
        if self.device.type != "cuda":
            return
        why = (f"overflow {failed.overflow}" if failed.overflow
               else "non-finite output")
        warnings.warn(
            f"{entry}: rung {failed.rung!r} on {failed.backend!r} failed "
            f"({why}); serving from {rung!r}, plain torch on "
            f"{self.device}", BackendDowngradeWarning, stacklevel=4)

    def _ladder(self, z, q, entry: str, batched: bool):
        attempts: list[GuardAttempt] = []
        phi, h, ok = self._attempt(self.solver, z, q, "primary", attempts,
                                   batched)
        if ok:
            return phi, self._report(entry, attempts)
        if h["nonfinite_input"]:
            # garbage in: nothing downstream can recover — fail loud now
            raise NonFiniteInputError(
                f"{entry}: z or q contain NaN/Inf; no recovery rung can "
                "repair a non-finite input "
                f"({self._report(entry, attempts).summary()})")

        # rung 1: cap escalation; the per-class margins pick which cap
        # doubles.
        solver = self.solver
        if h["overflow"]:
            for _ in range(self.max_cap_doublings):
                cfg = grow_caps(solver.cfg, h["margins"])
                solver = self._build(cfg, self.backend_name)
                phi, h, ok = self._attempt(
                    solver, z, q, f"caps*{cfg.strong_cap}/{cfg.weak_cap}",
                    attempts, batched)
                if ok:
                    self.solver = solver      # promote: re-planned
                    return phi, self._report(entry, attempts)
                if not h["overflow"]:
                    break                     # caps fixed; other fault left

        # rung 2: per-phase degradation — only a non-finite output can be
        # cured by swapping compute paths (a plain sweep at the same caps
        # would drop the same interactions).
        if self.allow_degrade and not h["overflow"] and h["nonfinite_output"]:
            for variant in filter(None, (
                    degraded_eval_backend(solver.backend),
                    get_backend("reference", self.device))):
                if variant.name == solver.backend.name:
                    continue
                deg = self._build(solver.cfg, variant.name)
                self._warn_plain(entry, f"degrade:{variant.name}",
                                 attempts[-1])
                phi, h, ok = self._attempt(
                    deg, z, q, f"degrade:{variant.name}", attempts, batched,
                    note="non-finite output: evaluation hooks -> plain "
                         f"torch sweeps on {self.device}")
                if ok:
                    return phi, self._report(entry, attempts)

        # rung 3: direct summation
        if self.allow_direct:
            self._warn_plain(entry, "direct", attempts[-1])
            phi, finite = self._direct_rung(z, q, attempts, batched)
            if finite:
                return phi, self._report(entry, attempts)

        report = self._report(entry, attempts)
        raise RecoveryExhaustedError(
            f"{entry}: every recovery rung failed — {report.summary()}",
            report=report)

    # -- guarded entry points -----------------------------------------------

    def apply_guarded(self, z, q):
        """``apply`` behind the full recovery ladder. Returns
        ``(phi, GuardReport)``; phi is never a silently truncated or
        non-finite answer — recovery failure raises instead."""
        return self._ladder(z, q, "apply", batched=False)

    def apply_batched_guarded(self, z, q):
        """``apply_batched`` behind the ladder: health is reduced across
        the batch, so one unhealthy row escalates the whole batch (the
        batch shares one cap budget). Returns ``(phi (B, N), report)``."""
        return self._ladder(z, q, "apply_batched", batched=True)

    def refresh_guarded(self, z, q):
        """``refresh`` with automatic re-planning: when the plan's
        margins show cap overflow (particles drifted past the budget),
        escalate the caps — bounded doublings — promote the escalated
        solver, and return its healthy plan. Returns ``(plan,
        GuardReport)``; feed the plan to ``apply_plan``. The cost over
        plain ``refresh`` is one host read of the margins and overflow
        per attempt (the span ``guard::read``, as each rung's read of the
        health plane)."""
        attempts: list[GuardAttempt] = []
        solver = self.solver
        for _ in range(self.max_cap_doublings + 1):
            rung = ("primary" if solver is self.solver
                    else f"caps*{solver.cfg.strong_cap}/{solver.cfg.weak_cap}")
            with self.rung_hook(rung):
                plan = solver.refresh(z, q)
                with trace.span("guard::read"):
                    host = torch.cat([plan.conn.margins.reshape(-1),
                                      plan.conn.overflow.reshape(-1)]).tolist()
            m = dict(zip(HEALTH_CLASSES, host[:len(HEALTH_CLASSES)]))
            overflow = host[-1]
            ok = overflow == 0
            attempts.append(GuardAttempt(
                rung=rung, backend=solver.dispatched["apply"],
                strong_cap=solver.cfg.strong_cap,
                weak_cap=solver.cfg.weak_cap, ok=ok,
                overflow=overflow, margins=m))
            if ok:
                if solver is not self.solver:
                    self.solver = solver       # promote the re-plan
                return plan, self._report("refresh", attempts)
            solver = self._build(grow_caps(solver.cfg, m), self.backend_name)
        report = self._report("refresh", attempts)
        raise CapOverflowError(
            f"refresh: caps still overflow after {self.max_cap_doublings} "
            f"doublings — {report.summary()}",
            margins=attempts[-1].margins, overflow=attempts[-1].overflow)

    # -- lattice warm-up ----------------------------------------------------

    def precompile(self, z, q) -> list[str]:
        """Warm the ladder's neighbouring plans ahead of the fault: build
        each rung's solver (the cap-doubling chain and the degradation
        variants) and run its ``apply_with_health`` once, so each prepares
        its device constants and becomes a ``FmmSolver.build`` cache hit.
        Returns the warmed rung names (``"<backend>@<S>/<W>"``)."""
        warmed = []
        cfg = self.solver.cfg
        chain = [(cfg, self.backend_name)]
        for _ in range(self.max_cap_doublings):
            cfg = grow_caps(cfg)
            chain.append((cfg, self.backend_name))
        if self.allow_degrade:
            deg = degraded_eval_backend(self.solver.backend)
            if deg is not None:
                chain.append((self.solver.cfg, deg.name))
            chain.append((self.solver.cfg, "reference"))
        for rung_cfg, backend in chain:
            self._build(rung_cfg, backend).apply_with_health(z, q)
            warmed.append(f"{backend}@{rung_cfg.strong_cap}/"
                          f"{rung_cfg.weak_cap}")
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return warmed
