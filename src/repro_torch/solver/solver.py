"""`FmmSolver` — the front-end over the FMM pipeline.

    solver = FmmSolver.build(cfg)            # cached per (cfg, backend, device)
    phi = solver.apply(z, q)                 # one problem, (N,) -> (N,)
    phib = solver.apply_batched(zb, qb)      # (B, N) -> (B, N)

The solver runs on ``cuda`` unless the caller passes ``device="cpu"``;
on a machine without a CUDA card the default raises instead of falling
back to the CPU. With the "cuda" backend each of the four kernels of the
main path runs exactly once per ``apply`` — and once per
``apply_batched``, whatever B: every kernel grid carries the problems as
an explicit axis.

``apply_with_health``/``apply_checked`` return or check the health plane
(cap margins, overflow, non-finite flags) computed beside phi.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch
from torch.profiler import record_function

from ..core.config import FmmConfig
from ..core.fmm import (HEALTH_CLASSES, Health, fmm_build, fmm_evaluate,
                        health_of, unsort)
from ..device import resolve_device
from ..errors import (CapOverflowError, DTypeError, NonFiniteInputError,
                      NonFiniteOutputError, ShapeError)
from .backends import Backend, get_backend

# LRU of solvers, keyed by (cfg, resolved backend name, device).
_CACHE: OrderedDict = OrderedDict()
_CACHE_MAX = 64


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


class FmmSolver:
    """FMM evaluator for one ``FmmConfig``, backend and device. Prefer
    ``FmmSolver.build``, which returns the cached instance."""

    def __init__(self, cfg: FmmConfig, backend: str = "auto", device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.backend_name = backend
        self.backend: Backend = get_backend(backend, self.device)
        self._impls = self.backend.phase_impls()
        self._topo = self.backend.topology_impls()
        # What each entry point actually runs, so timings cannot be
        # attributed to the wrong backend.
        self.dispatched = {"apply": self.backend.name,
                           "apply_batched": self.backend.name}

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
            solver = _CACHE[key] = cls(cfg, backend, dev)
            while len(_CACHE) > _CACHE_MAX:
                _CACHE.popitem(last=False)
        else:
            _CACHE.move_to_end(key)
        return solver

    @classmethod
    def cache_clear(cls) -> None:
        _CACHE.clear()

    # -- the pipeline -------------------------------------------------------

    def _core(self, z: torch.Tensor, q: torch.Tensor, with_health: bool):
        """(B, N) -> (B, N) phi in input order (+ the health plane)."""
        cfg = self.cfg
        plan = fmm_build(z, q, cfg, **self._topo)
        phi = fmm_evaluate(plan, cfg, **self._impls)
        with record_function("fmm::unsort"):
            phi = unsort(phi, plan.tree.perm)
        if with_health:
            with record_function("fmm::health"):
                return phi, health_of(plan, z, q, phi)
        return phi

    def _to_device(self, a) -> torch.Tensor:
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.array(a))
        return t.to(self.device, self.cfg.torch_complex)

    # -- evaluation ---------------------------------------------------------

    def apply(self, z, q) -> torch.Tensor:
        """phi_i = sum_{j != i} G(z_i, x_j) for one problem; input order.

        Trusts the caps: an input whose interaction lists exceed
        ``strong_cap``/``weak_cap`` silently drops interactions — use
        ``apply_checked`` where inputs may drift."""
        self._validate(z, q, "apply")
        return self._core(self._to_device(z)[None], self._to_device(q)[None],
                          False)[0]

    def apply_with_health(self, z, q):
        """``apply`` plus the health plane: ``(phi, Health)`` with the
        batch axis of the health fields kept (B = 1)."""
        self._validate(z, q, "apply_with_health")
        phi, health = self._core(self._to_device(z)[None],
                                 self._to_device(q)[None], True)
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
        the whole batch."""
        self._validate_batched(z, q)
        return self._core(self._to_device(z), self._to_device(q), False)

    def apply_batched_with_health(self, z, q):
        """``apply_batched`` plus the per-row health plane."""
        self._validate_batched(z, q)
        return self._core(self._to_device(z), self._to_device(q), True)

    def apply_batched_checked(self, z, q) -> torch.Tensor:
        """``apply_batched`` that raises when any row is unhealthy."""
        phi, health = self.apply_batched_with_health(z, q)
        raise_unhealthy(host_health(health), self.cfg,
                        "apply_batched_checked")
        return phi

    # -- argument validation (typed errors, repro_torch.errors) ------------

    def _validate_dtypes(self, z, q, entry: str) -> None:
        want = np.dtype(self.cfg.complex_dtype)
        for name, a in (("z", z), ("q", q)):
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
        self._validate_dtypes(z, q, entry)

    def _validate_batched(self, z, q) -> None:
        zs, qs = tuple(getattr(z, "shape", ())), tuple(getattr(q, "shape", ()))
        if len(zs) != 2:
            raise ShapeError(f"apply_batched wants (B, N); got {zs}")
        if zs[-1] != self.cfg.n:
            raise ShapeError(f"N={zs[-1]} != cfg.n={self.cfg.n}")
        if qs != zs:
            raise ShapeError(f"apply_batched wants q of shape {zs}; got {qs}")
        self._validate_dtypes(z, q, "apply_batched")
