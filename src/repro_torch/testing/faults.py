"""Deterministic fault injection for the guarded-execution ladder.

Each injector forces exactly one failure mode, so tests and the smoke
walk can drive the recovery ladder (``repro_torch.solver.guard``) rung
by rung instead of hoping a real fault shows up:

  truncate_interaction_lists  connectivity silently built at caps
                              ``drop`` smaller than the config declares
                              (the cap-drift fault: particles moved past
                              the tuned budget) — honest margins, so the
                              health plane detects it and ONE cap
                              doubling recovers
  force_cap_overflow          connectivity clamped to absolute tiny caps
                              at ANY declared config — cap escalation
                              can never win, the ladder must walk
                              through to the direct O(N^2) rung
  nan_coefficients            a backend phase hook poisoned to emit NaN
                              (the kernel-fault mode): the real hook runs
                              first (on the card its kernel launches),
                              then its output is multiplied by NaN —
                              detected by the non-finite-output flag,
                              recovered by the per-phase degradation rung
  poison_input                NaN planted in z/q (caller-side garbage) —
                              detected by the non-finite-input flag,
                              *unrecoverable* by design: the ladder
                              raises ``NonFiniteInputError`` immediately

The connectivity injectors patch the ``build_connectivity`` binding that
``repro_torch.core.fmm.fmm_build`` calls; ``nan_coefficients``
re-registers the backend. Each calls ``FmmSolver.cache_clear()`` on
enter AND exit, which also releases the cached solvers' programs, so
solvers built inside the context carry the fault and solvers built
outside never share a cache entry with them. Build the
``GuardedSolver`` *inside* the context: a solver keeps the backend hooks
it captured at construction (a registry poison never leaks into one
built before), while the patched connectivity binding is read whenever
a program is made (``solver.program``: at a solver's first call at a
shape; its eager run and its capture both run that binding). A solver
cached before entry is released on entry, so its next call makes its
programs with the fault; it is out of the cache at exit, so its programs
keep the fault until it is released again — as the reference's held
solver keeps its traced fault.

The smoke walk (every injector, the full ladder; on the CUDA card unless
``--device cpu``):

    PYTHONPATH=src python -m repro_torch.testing.faults [--device cpu]
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from ..core import fmm as _fmm
from ..core.config import FmmConfig
from ..core.topology import Connectivity
from ..solver.backends import get_backend, register_backend
from ..solver.solver import FmmSolver


# ---------------------------------------------------------------------------
# connectivity truncation (cap-overflow family)
# ---------------------------------------------------------------------------

def _truncate(lst: torch.Tensor, cap: int) -> torch.Tensor:
    """Drop list entries beyond ``cap`` (shape stays the declared one)."""
    if lst.shape[-1] <= cap:
        return lst
    out = lst.clone()
    out[..., cap:] = -1
    return out


def _max_count(arrays) -> torch.Tensor:
    """Fullest row per problem over a group of padded (B, boxes, cap)
    lists (kept entries are >= 0): (B,)."""
    return torch.stack([(a >= 0).sum(-1).amax(-1) for a in arrays]).amax(0)


def _truncated_connectivity(conn: Connectivity, eff_strong: int,
                            eff_weak: int) -> Connectivity:
    """``conn`` as if it had been built at the smaller *effective* caps:
    entries beyond them dropped, margins/overflow recomputed against
    them per problem — the fault is honest, exactly like a real
    undersized build."""
    margins = torch.stack([
        eff_strong - _max_count(conn.strong),
        eff_weak - _max_count(conn.weak),
        eff_strong - _max_count([conn.p2p]),
        eff_strong - _max_count([conn.p2l]),
        eff_strong - _max_count([conn.m2p]),
    ], dim=-1).to(torch.int32)
    overflow = torch.clamp(-margins.amin(dim=-1), min=0).to(torch.int32)
    return conn._replace(
        strong=tuple(_truncate(s, eff_strong) for s in conn.strong),
        weak=tuple(_truncate(w, eff_weak) for w in conn.weak),
        p2p=_truncate(conn.p2p, eff_strong),
        p2l=_truncate(conn.p2l, eff_strong),
        m2p=_truncate(conn.m2p, eff_strong),
        overflow=overflow, margins=margins)


@contextlib.contextmanager
def _patched_connectivity(effective_caps):
    """Patch the ``build_connectivity`` binding that ``fmm_build`` calls
    (``repro_torch.core.fmm``'s) with a truncating wrapper.
    ``effective_caps(cfg) -> (strong, weak)`` picks the effective caps
    per config, so an escalated config sees proportionally wider
    effective lists — the fault composes with the recovery ladder."""
    real = _fmm.build_connectivity

    def faulty(tree, cfg, leaf_classify_impl=None):
        conn = real(tree, cfg, leaf_classify_impl=leaf_classify_impl)
        es, ew = effective_caps(cfg)
        return _truncated_connectivity(conn, max(1, int(es)),
                                       max(1, int(ew)))

    FmmSolver.cache_clear()
    _fmm.build_connectivity = faulty
    try:
        yield
    finally:
        _fmm.build_connectivity = real
        FmmSolver.cache_clear()


@contextlib.contextmanager
def truncate_interaction_lists(drop: int = 2):
    """Cap-drift fault: every interaction list is silently built ``drop``
    entries short of what the config declares. A config whose margins
    were < ``drop`` overflows; doubling the caps restores slack (the
    effective caps scale with the declared ones), so the guard's cap-
    escalation rung recovers without degrading the backend."""
    with _patched_connectivity(
            lambda cfg: (cfg.strong_cap - drop, cfg.weak_cap - drop)):
        yield


@contextlib.contextmanager
def force_cap_overflow(strong: int = 1, weak: int = 1):
    """Overflow that no escalation cures: effective caps clamped to tiny
    absolute values whatever the config declares, so the ladder must
    fall through to the direct O(N^2) rung."""
    with _patched_connectivity(
            lambda cfg: (min(strong, cfg.strong_cap),
                         min(weak, cfg.weak_cap))):
        yield


# ---------------------------------------------------------------------------
# kernel fault (non-finite output family)
# ---------------------------------------------------------------------------

def _times_nan(out):
    if isinstance(out, torch.Tensor):
        return out * float("nan")
    return type(out)(_times_nan(o) for o in out)


@contextlib.contextmanager
def nan_coefficients(backend: str = "cuda", phase: str = "eval_fused"):
    """Kernel fault: re-register ``backend`` with its ``phase`` hook
    wrapped to run the real hook and multiply its output by NaN (on the
    device, so the product is captured into the program's graph) —
    deterministic non-finite coefficients/potentials from one compute
    phase, finite input. The health plane flags ``nonfinite_output``;
    the guard's per-phase degradation rung (the plain sweeps for the
    evaluation phase and the upward pass) recovers."""
    be = get_backend(backend)
    hook = getattr(be, phase)
    if hook is None:
        raise ValueError(
            f"backend {backend!r} has no {phase!r} hook to poison "
            "(already the plain path?)")

    def poisoned(*args, **kwargs):
        return _times_nan(hook(*args, **kwargs))

    FmmSolver.cache_clear()
    register_backend(dataclasses.replace(be, **{phase: poisoned}))
    try:
        yield
    finally:
        register_backend(be)
        FmmSolver.cache_clear()


# ---------------------------------------------------------------------------
# input fault (non-finite input family)
# ---------------------------------------------------------------------------

def poison_input(arr, idx: int = 0):
    """A copy of ``arr`` (tensor, on its device, or numpy array) with a
    NaN at ``arr[..., idx]`` — caller-side garbage input. The guard
    refuses it (``NonFiniteInputError``): no recovery rung can repair an
    input that carries no information."""
    out = arr.clone() if isinstance(arr, torch.Tensor) else np.array(arr)
    out[..., idx] = float("nan")
    return out


# ---------------------------------------------------------------------------
# the smoke walk: every injector drives its rung of the ladder
# ---------------------------------------------------------------------------

def smoke_cases(cfg: FmmConfig, *, backend: str = "cuda", device=None,
                drop: int = 20, rung_hook=None):
    """The smoke walk's five cases as ``(case, expected rung, run)``;
    ``run(z, q)`` builds its ``GuardedSolver`` inside its fault and
    returns ``apply_guarded``'s ``(phi, report)``. The last case
    ("nan-input", expected rung None) raises ``NonFiniteInputError``.
    ``drop`` must exceed the strong family's smallest margin at ``cfg``
    (20 at the reference's n = 256 config, whose strong margin is 16).
    ``rung_hook`` goes to every ``GuardedSolver`` of the walk.
    """
    from ..solver.guard import GuardedSolver

    def guarded(**kw):
        return GuardedSolver(cfg, backend, device=device,
                             rung_hook=rung_hook, **kw)

    def healthy(z, q):
        return guarded(max_cap_doublings=2).apply_guarded(z, q)

    def truncate(z, q):
        with truncate_interaction_lists(drop=drop):
            return guarded(max_cap_doublings=2).apply_guarded(z, q)

    def nan_kernel(z, q):
        with nan_coefficients(backend, "eval_fused"):
            return guarded(max_cap_doublings=2).apply_guarded(z, q)

    def forced_overflow(z, q):
        with force_cap_overflow(strong=1, weak=1):
            return guarded(max_cap_doublings=1).apply_guarded(z, q)

    def nan_input(z, q):
        return guarded().apply_guarded(poison_input(z), q)

    name = get_backend(backend, device).name
    return [
        ("healthy", "primary", healthy),
        ("truncate->caps*2", f"caps*{2 * cfg.strong_cap}/{cfg.weak_cap}",
         truncate),
        ("nan-kernel->degrade", f"degrade:{name}+ref-eval", nan_kernel),
        ("forced-overflow->direct", "direct", forced_overflow),
        ("nan-input", None, nan_input),
    ]


def _smoke(argv=None) -> int:     # pragma: no cover - run as a script
    import argparse

    from ..core.direct import direct_potential
    from ..data.synthetic import particles
    from ..errors import NonFiniteInputError

    ap = argparse.ArgumentParser(
        description="Walk every rung of the guarded-execution ladder.")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = FmmConfig(n=256, nlevels=2, p=12, dtype="f64",
                    strong_cap=32, weak_cap=64)
    z, q = particles("normal", cfg.n, 3, device=args.device)
    oracle = direct_potential(z, z, q, kernel=cfg.kernel)
    scale = float(oracle.abs().max())
    failures = []

    print(f"fault-injection smoke on {z.device}: walking the recovery "
          "ladder")
    for case, expect, run in smoke_cases(cfg, device=args.device):
        if expect is None:
            try:
                run(z, q)
                print(f"FAIL  {case} did not raise")
                failures.append(case)
            except NonFiniteInputError:
                print(f"ok    {case} -> NonFiniteInputError "
                      "(unrecoverable)")
            continue
        phi, rep = run(z, q)
        err = float((phi - oracle).abs().max()) / scale
        tol = 1e-10 if expect == "direct" else 1e-6
        ok = (rep.ok and expect in [a.rung for a in rep.attempts]
              and err < tol)
        if case == "healthy":
            ok = ok and rep.retries == 0
        if case.startswith("truncate"):
            ok = ok and rep.degradations == ()
        print(("ok " if ok else "FAIL ")
              + f"  {case:<28s} {rep.summary()}  rel_err={err:.2e}")
        if not ok:
            failures.append(case)

    print("smoke:", "FAILED " + ",".join(failures) if failures else "all ok")
    return 1 if failures else 0


if __name__ == "__main__":     # pragma: no cover
    raise SystemExit(_smoke())
