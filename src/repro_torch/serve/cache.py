"""Keyed solver cache for the serving plane.

The twin of ``repro.serve.cache``. ``FmmSolver.build`` already memoizes
solvers per ``(FmmConfig, backend, device)`` in a bounded LRU. Serving
adds two more key axes that change what a solver prepares: the
**bucket** (padded problem size — ``FmmConfig.n`` is a static shape) and
the **batch width** B (``apply_batched`` prepares per (B, N); see
``FmmSolver.trace_counts``). This module extends the solver LRU upward
into a ``(bucket, batch, backend)``-keyed cache of *guarded* solvers on
one device:

  - each entry is a ``GuardedSolver`` pinned to one (bucket, B) shape
    class — it persists across requests, so cap escalations learned
    from traffic (guard promotion) stick to the shape class;
  - ``warm`` prepares an entry ahead of traffic (the batched health
    entry point every guarded dispatch runs);
  - eviction is LRU with per-bucket hit/miss/eviction counters
    (``info``), the serving analogue of ``FmmSolver.cache_info()``.

The reference's keyed programs are jit-compiled; the port's entries hold
solvers whose programs are captured as CUDA graphs once per shape
(``repro_torch.solver.program``): on the card ``warm`` runs the batched
health program of its (bucket, B) twice, which captures it, and every
guarded dispatch of that shape class replays it. The leaf layout lives
as long as a solver that holds it (``FmmSolver._prepare``).
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..core.config import FmmConfig
from ..device import resolve_device
from ..solver.guard import GuardedSolver


class BucketCacheStats(NamedTuple):
    """Per-bucket hit/miss/eviction counters of the serving cache."""

    hits: int
    misses: int
    evictions: int


def default_cfg_factory(n: int, *, p: int = 17, dtype: str = "f32",
                        strong_cap: int = 48,
                        weak_cap: int = 128) -> FmmConfig:
    """Bucket size -> ``FmmConfig`` (paper calibration: eq. (5.2) depth)."""
    from ..configs.fmm2d import fmm_config

    cfg = fmm_config(n, p=p, dtype=dtype)
    return dataclasses.replace(cfg, strong_cap=strong_cap,
                               weak_cap=weak_cap)


class PlanCache:
    """LRU of guarded solvers keyed by (bucket, batch, backend), all on
    ``device`` (default: the CUDA card; one cache serves one device).

    ``get`` returns ``(guarded_solver, hit)``; ``warm`` prepares the
    entry's batched health program on synthetic data (on the card it
    captures it) so the first real request finds it ready.
    """

    def __init__(self, cfg_factory: Callable[[int], FmmConfig],
                 backend: str = "auto", *, max_entries: int = 16,
                 max_cap_doublings: int = 3, device=None):
        if max_entries < 1:
            raise ValueError("max_entries must be >= 1")
        self.cfg_factory = cfg_factory
        self.backend = backend
        self.max_entries = max_entries
        self.max_cap_doublings = max_cap_doublings
        self.device = resolve_device(device)
        self._entries: OrderedDict[tuple, GuardedSolver] = OrderedDict()
        self._stats: dict[int, dict] = {}

    # -- bookkeeping --------------------------------------------------------

    def _bucket_stats(self, bucket: int) -> dict:
        return self._stats.setdefault(
            bucket, {"hits": 0, "misses": 0, "evictions": 0})

    def info(self) -> dict[int, BucketCacheStats]:
        """Per-bucket counters (plus ``currsize``/``maxsize`` totals via
        ``len(cache)`` and ``cache.max_entries``)."""
        return {b: BucketCacheStats(s["hits"], s["misses"], s["evictions"])
                for b, s in sorted(self._stats.items())}

    def __len__(self) -> int:
        return len(self._entries)

    def clear(self) -> None:
        self._entries.clear()
        self._stats.clear()

    # -- the solver cache ---------------------------------------------------

    def get(self, bucket: int, batch: int) -> tuple[GuardedSolver, bool]:
        """The guarded solver of one (bucket, batch) shape class.

        A hit returns the *same* ``GuardedSolver`` instance — including
        any cap escalation its guard promoted from earlier traffic."""
        key = (bucket, batch, self.backend)
        stats = self._bucket_stats(bucket)
        entry = self._entries.get(key)
        if entry is not None:
            stats["hits"] += 1
            self._entries.move_to_end(key)
            return entry, True
        stats["misses"] += 1
        entry = GuardedSolver(self.cfg_factory(bucket), self.backend,
                              max_cap_doublings=self.max_cap_doublings,
                              device=self.device)
        self._entries[key] = entry
        while len(self._entries) > self.max_entries:
            (ev_bucket, _, _), _ = self._entries.popitem(last=False)
            self._bucket_stats(ev_bucket)["evictions"] += 1
        return entry, False

    def warm(self, bucket: int, batch: int,
             seed: int = 0) -> GuardedSolver:
        """Prepare one shape class ahead of traffic: run the batched
        health entry point (what guarded dispatch runs) on synthetic
        particles, once on the CPU and twice on the card (the second run
        captures its program), and wait for the device. Idempotent;
        returns the cached entry."""
        from ..data.synthetic import particles_numpy

        guarded, _ = self.get(bucket, batch)
        cfg = guarded.cfg
        z, q = particles_numpy("uniform", bucket, seed)
        zb, qb = (torch.as_tensor(np.broadcast_to(
            a.astype(cfg.complex_dtype), (batch, bucket)).copy(),
            device=self.device) for a in (z, q))
        guarded.solver.apply_batched_with_health(zb, qb)
        if self.device.type == "cuda":
            guarded.solver.apply_batched_with_health(zb, qb)
            torch.cuda.synchronize(self.device)
        return guarded

    def warm_all(self, buckets, batches) -> list[tuple[int, int]]:
        """Warm the cross product ``buckets`` x ``batches``; returns the
        warmed (bucket, batch) pairs in order."""
        warmed = []
        for b in buckets:
            for w in batches:
                self.warm(b, w)
                warmed.append((b, w))
        return warmed

    def entry(self, bucket: int, batch: int) -> Optional[GuardedSolver]:
        """Peek without touching LRU order or counters (tests)."""
        return self._entries.get((bucket, batch, self.backend))
