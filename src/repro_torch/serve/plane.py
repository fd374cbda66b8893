"""The serving plane: ragged, faulty traffic onto the batched pipeline.

The twin of ``repro.serve.plane``. ``ServePlane.serve`` accepts a stream
of heterogeneous ``(z, q)`` requests and routes them onto the batched
main path (on "cuda": classify once a level, level-fused M2L, P2L and
the fused evaluation once, a dispatch and guard attempt) through three
layers:

  admission     eager, per-request: shape/dtype screening, non-finite
                input refusal (a poison request must not ride into a
                batch — batched health is reduced across rows, so one
                NaN row would fail the whole dispatch), deadline-budget
                checks, oversize triage
  dispatch      shape bucketing (``BucketLattice`` + zero-charge tail
                padding — exact for the real rows), batch-width
                rounding to a power of two, one ``apply_batched``
                guarded call per group through the keyed solver cache
                (``PlanCache``); the ``StragglerMonitor`` from the
                launch runtime flags slow dispatches
  degradation   typed faults the per-call guard ladder cannot absorb
                shed explicitly, with backoff, per request: next-larger
                bucket -> reference backend -> direct O(N^2) for small
                N -> typed rejection. Every decision lands in a
                structured ``ServeReport``.

Every request is batched on the host (numpy), copied to the plane's
device in one ``torch.as_tensor`` a dispatch, and its phi copied back
before the dispatch's clock stops, so the straggler monitor times the
device's work.

Spans (``repro_torch.trace``, on the trace's clock, not the plane's
``clock``): ``serve::wave`` is one ``serve`` call; inside it
``serve::admit`` (admission of the wave), and for each dispatch
``serve::cache`` (the ``PlanCache`` lookup), ``serve::pack`` (padding,
stacking and the copy to the device), ``serve::apply`` (the guarded
batched apply and the copy back) and ``serve::unpack`` (the reports);
``serve::queue``, tagged with the request's ``rid``, runs from its
wave's start to the start of its dispatch's ``serve::pack``.

Departures from the reference, both so that a broken kernel cannot hide
behind a correct answer:

  - **Only typed faults are shed.** The dispatch and the shed steps
    catch ``FmmError`` (the guard's ``RecoveryExhaustedError`` and
    ``CapOverflowError``, ``NonFiniteOutputError``, validation errors),
    not ``Exception``. Anything else leaves ``serve``: a ``RuntimeError``
    from ``nvcc`` or from a kernel launch, a torch CUDA error. The
    reference sheds every exception.
  - **Plain torch on the card warns.** On a CUDA device, a step that
    answers from plain torch (``shed:reference``, ``shed:direct``, and
    ``oversize->direct`` at admission) emits ``BackendDowngradeWarning``
    naming the step and why, as the guard's degrade and direct rungs do.
    On the CPU nothing warns, as in the reference.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
import warnings
from typing import Any, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .. import trace
from ..core.direct import direct_potential
from ..device import resolve_device
from ..errors import (BackendDowngradeWarning, DeadlineExceededError,
                      DTypeError, FmmError, NonFiniteInputError,
                      OversizedRequestError, ShapeError)
from ..launch.runtime import StragglerMonitor
from .buckets import BucketLattice, pad_problem, unpad
from .cache import PlanCache, default_cfg_factory

#: ``ServeReport.status`` values, in decreasing order of health.
STATUSES = ("ok", "recovered", "degraded", "rejected")


@dataclasses.dataclass
class Request:
    """One serving request: positions, charges, optional deadline budget
    (seconds from admission). ``rid`` is assigned by the plane when
    None."""

    z: Any
    q: Any
    deadline_s: Optional[float] = None
    rid: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class ServeReport:
    """Structured record of every decision made for one request.

    ``status``: "ok" (primary rung, no retries), "recovered" (the guard
    ladder escalated caps and recovered — answer trustworthy),
    "degraded" (served off the fast path: backend degradation, bucket
    reroute, or direct O(N^2) — answer trustworthy, latency/cost
    degraded), "rejected" (no trustworthy answer; ``error`` carries the
    typed error name). ``path`` is the ordered decision trail
    (admission, rungs walked, shed steps). ``slow`` flags a dispatch
    the straggler monitor considered an outlier."""

    rid: int
    n: int
    status: str
    path: tuple[str, ...] = ()
    bucket: Optional[int] = None
    batch: Optional[int] = None
    backend: Optional[str] = None
    cache: Optional[str] = None
    latency_s: float = 0.0
    slow: bool = False
    deadline_s: Optional[float] = None
    deadline_exceeded: bool = False
    retries: int = 0
    error: Optional[str] = None
    error_msg: Optional[str] = None

    def summary(self) -> str:
        trail = " -> ".join(self.path) or "(direct admission)"
        tail = f" error={self.error}" if self.error else ""
        ddl = " DEADLINE-MISS" if self.deadline_exceeded else ""
        slow = " SLOW" if self.slow else ""
        return (f"[serve:req{self.rid}] n={self.n} -> "
                f"bucket={self.bucket}/B={self.batch} "
                f"{self.status} ({trail}) backend={self.backend} "
                f"cache={self.cache} {self.latency_s * 1e3:.1f}ms"
                f"{tail}{ddl}{slow}")


class ServeResult(NamedTuple):
    """(phi, report): phi is a numpy array of length n, or None when
    the request was rejected (``report.error`` says why)."""

    phi: Optional[np.ndarray]
    report: ServeReport


def _batch_width(k: int, max_batch: int) -> int:
    """Round a group size up to the power-of-two batch lattice (<= max):
    one prepared shape per (bucket, width) instead of per count."""
    w = 1
    while w < k and w < max_batch:
        w *= 2
    return min(w, max_batch)


class _Item:
    """Mutable per-request serving state (internal)."""

    def __init__(self, idx: int, req: Request, now: float):
        self.idx = idx
        self.req = req
        self.rid = req.rid if req.rid is not None else idx
        self.t_admit = now
        self.z: Optional[np.ndarray] = None
        self.q: Optional[np.ndarray] = None
        self.n = 0
        self.bucket: Optional[int] = None
        self.path: list[str] = []
        self.result: Optional[ServeResult] = None


class ServePlane:
    """Robust dispatcher from ragged request streams onto the batched
    pipeline (module docstring).

        plane = ServePlane(BucketLattice.geometric(64, 4096))   # the card
        results = plane.serve([Request(z1, q1), Request(z2, q2, 0.5)])
        for phi, report in results:
            print(report.summary())

    ``device`` (default: the CUDA card, resolved here, so a plane made
    without one raises ``DeviceUnavailableError`` when built) is where
    every dispatch runs. ``clock``/``sleep`` are injectable for tests and
    fault injection; ``monitor`` is the slow-request detector (a
    ``StragglerMonitor`` from the launch runtime — per-dispatch wall
    time against a rolling median)."""

    def __init__(self, lattice: Optional[BucketLattice] = None, *,
                 backend: str = "auto", cfg_factory=None,
                 max_batch: int = 8, direct_max: int = 4096,
                 default_deadline_s: Optional[float] = None,
                 cache_entries: int = 16, max_cap_doublings: int = 3,
                 backoff_s: Sequence[float] = (0.0, 0.02, 0.1),
                 monitor: Optional[StragglerMonitor] = None,
                 clock=time.perf_counter, sleep=time.sleep, device=None):
        self.device = resolve_device(device)
        self.lattice = lattice or BucketLattice.geometric(64, 1 << 14)
        self.backend = backend
        self.cfg_factory = cfg_factory or default_cfg_factory
        self.max_batch = max(1, int(max_batch))
        self.direct_max = direct_max
        self.default_deadline_s = default_deadline_s
        self.backoff_s = tuple(backoff_s)
        self.clock = clock
        self.sleep = sleep
        self.monitor = monitor or StragglerMonitor(window=64,
                                                   threshold=3.0, warmup=1)
        self.cache = PlanCache(self.cfg_factory, backend,
                               max_entries=cache_entries,
                               max_cap_doublings=max_cap_doublings,
                               device=self.device)
        # the shed ladder's reference-backend rung gets its own small
        # cache (only faulted traffic reaches it)
        self._ref_cache = PlanCache(self.cfg_factory, "reference",
                                    max_entries=4,
                                    max_cap_doublings=max_cap_doublings,
                                    device=self.device)
        self._rid_counter = itertools.count()
        self._dispatches = 0
        self.counters = {s: 0 for s in STATUSES}
        self.counters.update(requests=0, dispatches=0, slow_dispatches=0,
                             deadline_misses=0, shed_walks=0)

    # -- public API ---------------------------------------------------------

    def warm(self, buckets=None, batches=(1,)) -> list[tuple[int, int]]:
        """Prepare shape classes ahead of traffic (the warm-up half of
        the keyed solver cache)."""
        buckets = list(buckets) if buckets is not None else \
            list(self.lattice.sizes)
        return self.cache.warm_all(buckets, batches)

    def submit(self, z, q, deadline_s: Optional[float] = None) -> ServeResult:
        """Serve one request (convenience over ``serve``)."""
        return self.serve([Request(z, q, deadline_s)])[0]

    def serve(self, requests: Sequence[Request]) -> list[ServeResult]:
        """Serve a wave of requests; results in submission order.

        Never raises for a request-level fault: every request comes back
        as ``(phi, report)`` or ``(None, report-with-typed-error)``. A
        fault outside the typed taxonomy (a kernel that fails to build
        or launch) is not a request-level fault and raises."""
        with trace.span("serve::wave") as wave:
            now = self.clock()
            items = [_Item(next(self._rid_counter), r, now)
                     for r in requests]
            self.counters["requests"] += len(items)

            admitted: dict[int, list[_Item]] = {}
            with trace.span("serve::admit"):
                for it in items:
                    self._admit(it, admitted)

            for bucket in sorted(admitted):
                queue = admitted[bucket]
                while queue:
                    chunk = []
                    while queue and len(chunk) < self.max_batch:
                        it = queue.pop(0)
                        if self._deadline_expired(it, "dispatch"):
                            continue
                        chunk.append(it)
                    if chunk:
                        self._dispatch(bucket, chunk, wave)

            for it in items:
                if it.result is None:     # pragma: no cover - defensive
                    it.result = self._reject(it, FmmError(
                        "request fell through the dispatch plan"), "lost")
            return [it.result for it in items]

    def stats(self) -> dict:
        """Cumulative serving counters + per-bucket cache traffic +
        straggler state — the plane's observability surface."""
        return {
            **self.counters,
            "cache": {b: s._asdict() for b, s in self.cache.info().items()},
            "cache_size": len(self.cache),
            "dispatch_median_s": self.monitor.median,
            "slow_requests": list(self.monitor.slow_steps),
        }

    # -- admission ----------------------------------------------------------

    def _admit(self, it: _Item, admitted: dict) -> None:
        req = it.req
        try:
            z = np.asarray(req.z)
            q = np.asarray(req.q)
        except Exception as e:       # not array-able at all
            it.result = self._reject(it, ShapeError(f"unreadable input: {e}"),
                                     "admission")
            return
        if z.ndim != 1 or z.shape != q.shape or z.size == 0:
            it.result = self._reject(it, ShapeError(
                f"serve wants matching non-empty 1-D z/q; got z{z.shape} "
                f"q{q.shape}"), "admission")
            return
        it.n = z.size
        if not np.issubdtype(z.dtype, np.complexfloating):
            it.result = self._reject(it, DTypeError(
                f"serve wants complex positions z = x + iy; got "
                f"{z.dtype.name} (a real-valued position array is a "
                "complex-vs-real confusion)"), "admission")
            return
        if not np.issubdtype(q.dtype, np.complexfloating):
            q = q.astype(np.complex128)
            it.path.append("cast:q-complex")
        if not (np.all(np.isfinite(z.real)) and np.all(np.isfinite(z.imag))
                and np.all(np.isfinite(q.real))
                and np.all(np.isfinite(q.imag))):
            it.result = self._reject(it, NonFiniteInputError(
                "z or q contain NaN/Inf — poison request refused at "
                "admission (it would fail the whole batch)"), "admission")
            return
        it.z, it.q = z, q
        if self._deadline_expired(it, "admission"):
            return
        bucket = self.lattice.bucket_for(it.n)
        if bucket is None:
            if it.n <= self.direct_max:
                it.path.append("oversize->direct")
                self._warn_plain(it, "oversize->direct",
                                 f"n={it.n} exceeds the bucket lattice "
                                 f"(max {self.lattice.max_size})")
                self._direct_rung(it)
            else:
                it.result = self._reject(it, OversizedRequestError(
                    f"n={it.n} exceeds the bucket lattice "
                    f"(max {self.lattice.max_size}) and the direct "
                    f"fallback bound ({self.direct_max})"), "admission")
            return
        it.bucket = bucket
        admitted.setdefault(bucket, []).append(it)

    def _remaining(self, it: _Item) -> Optional[float]:
        ddl = it.req.deadline_s if it.req.deadline_s is not None \
            else self.default_deadline_s
        if ddl is None:
            return None
        return ddl - (self.clock() - it.t_admit)

    def _deadline_expired(self, it: _Item, where: str) -> bool:
        rem = self._remaining(it)
        if rem is not None and rem <= 0:
            it.path.append(f"deadline:{where}")
            it.result = self._reject(it, DeadlineExceededError(
                f"deadline budget exhausted at {where} "
                f"({-rem:.3f}s over)"), None)
            return True
        return False

    # -- dispatch -----------------------------------------------------------

    def _dispatch(self, bucket: int, chunk: list[_Item],
                  wave: trace.span) -> None:
        width = _batch_width(len(chunk), self.max_batch)
        with trace.span("serve::cache"):
            guarded, hit = self.cache.get(bucket, width)
        cfg = guarded.cfg
        with trace.span("serve::pack") as pack:
            for it in chunk:
                trace.record("serve::queue", wave.start, pack.start,
                             tag=it.rid, parent=wave.id)
            rows_z, rows_q = [], []
            for it in chunk:
                zp, qp = pad_problem(it.z, it.q, bucket,
                                     dtype=cfg.complex_dtype)
                rows_z.append(zp.astype(cfg.complex_dtype))
                rows_q.append(qp.astype(cfg.complex_dtype))
            while len(rows_z) < width:   # filler rows: discard on unpack
                rows_z.append(rows_z[0])
                rows_q.append(rows_q[0])
            zb = torch.as_tensor(np.stack(rows_z), device=self.device)
            qb = torch.as_tensor(np.stack(rows_q), device=self.device)

        t0 = self.clock()
        step = self._dispatches
        self._dispatches += 1
        self.counters["dispatches"] += 1
        try:
            with trace.span("serve::apply"):
                phi_b, greport = guarded.apply_batched_guarded(zb, qb)
                phi_b = phi_b.cpu().numpy()
        except FmmError as e:
            dt = self.clock() - t0
            self.monitor.record(step, dt)
            for it in chunk:
                it.path.append(f"batch-fault:{type(e).__name__}")
                self._shed(it, e)
            return
        dt = self.clock() - t0
        slow = self.monitor.record(step, dt)
        if slow:
            self.counters["slow_dispatches"] += 1

        rungs = tuple(a.rung for a in greport.attempts)
        if greport.retries == 0:
            status = "ok"
        elif not greport.degradations:
            status = "recovered"
        else:
            status = "degraded"
        with trace.span("serve::unpack"):
            for row, it in enumerate(chunk):
                self._finish(it, unpad(phi_b[row], it.n), status,
                             path=it.path + list(rungs),
                             bucket=bucket, batch=width,
                             backend=greport.final_backend,
                             cache="hit" if hit else "miss",
                             retries=greport.retries, slow=slow)

    # -- overload shedding / degradation ------------------------------------

    def _shed(self, it: _Item, first_error: FmmError) -> None:
        """Per-request degradation after a failed batch dispatch:
        next-larger bucket -> reference backend -> direct O(N^2) ->
        typed rejection, with backoff between steps."""
        self.counters["shed_walks"] += 1
        last_error = first_error
        steps = []
        nxt = self.lattice.next_larger(it.bucket) if it.bucket else None
        if nxt is not None:
            steps.append(("shed:bucket:%d" % nxt,
                          lambda: self._guarded_single(it, self.cache, nxt)))
        steps.append(("shed:reference",
                      lambda: self._guarded_single(
                          it, self._ref_cache, it.bucket or
                          self.lattice.bucket_for(it.n))))
        backoffs = list(self.backoff_s) + \
            [self.backoff_s[-1]] * max(0, len(steps) + 1 - len(self.backoff_s))
        for (label, fn), backoff in zip(steps, backoffs):
            if self._deadline_expired(it, label):
                return
            if backoff:
                self.sleep(backoff)
            it.path.append(label)
            if label == "shed:reference":
                self._warn_plain(it, label, f"{type(last_error).__name__}: "
                                 f"{last_error}")
            try:
                phi, greport = fn()
                self._finish(it, phi, "degraded",
                             path=it.path + [a.rung for a in
                                             greport.attempts],
                             bucket=it.bucket, batch=1,
                             backend=greport.final_backend,
                             cache=None, retries=greport.retries)
                return
            except FmmError as e:
                last_error = e
                it.path.append(f"failed:{type(e).__name__}")
        if it.n <= self.direct_max:
            if self._deadline_expired(it, "shed:direct"):
                return
            if backoffs:
                self.sleep(backoffs[-1])
            it.path.append("shed:direct")
            self._warn_plain(it, "shed:direct",
                             f"{type(last_error).__name__}: {last_error}")
            self._direct_rung(it)
            return
        it.result = self._reject(it, last_error, None)

    def _guarded_single(self, it: _Item, cache: PlanCache, bucket: int):
        """One request through a (bucket, B=1) guarded solver."""
        guarded, _ = cache.get(bucket, 1)
        cfg = guarded.cfg
        zp, qp = pad_problem(it.z, it.q, bucket, dtype=cfg.complex_dtype)
        phi, greport = guarded.apply_guarded(
            torch.as_tensor(zp.astype(cfg.complex_dtype), device=self.device),
            torch.as_tensor(qp.astype(cfg.complex_dtype), device=self.device))
        return unpad(phi.cpu().numpy(), it.n), greport

    def _direct_rung(self, it: _Item) -> None:
        """Capless O(N^2) evaluation at the request's exact N (no
        padding, no buckets — the floor of the degradation ladder), in
        plain torch on the plane's device."""
        cfg_kernel = self.cfg_factory(max(
            self.lattice.sizes[0], 4)).kernel
        z = torch.as_tensor(it.z, device=self.device)
        phi = direct_potential(z, z, torch.as_tensor(it.q, device=self.device),
                               kernel=cfg_kernel).cpu().numpy()
        self._finish(it, phi, "degraded", path=it.path + ["direct"],
                     bucket=None, batch=None, backend="direct", cache=None)

    def _warn_plain(self, it: _Item, step: str, why: str) -> None:
        """On a CUDA device, warn that ``step`` answers request ``it``
        from plain torch in place of the kernels, and why."""
        if self.device.type != "cuda":
            return
        warnings.warn(
            f"serve: request {it.rid} (n={it.n}) takes step {step!r} ({why});"
            f" answering from plain torch on {self.device}",
            BackendDowngradeWarning, stacklevel=3)

    # -- report assembly ----------------------------------------------------

    def _finish(self, it: _Item, phi: np.ndarray, status: str, *,
                path, bucket, batch, backend, cache, retries: int = 0,
                slow: bool = False) -> None:
        latency = self.clock() - it.t_admit
        ddl = it.req.deadline_s if it.req.deadline_s is not None \
            else self.default_deadline_s
        missed = ddl is not None and latency > ddl
        if missed:
            self.counters["deadline_misses"] += 1
        self.counters[status] += 1
        it.result = ServeResult(phi, ServeReport(
            rid=it.rid, n=it.n, status=status, path=tuple(path),
            bucket=bucket, batch=batch, backend=backend, cache=cache,
            latency_s=latency, slow=slow, deadline_s=ddl,
            deadline_exceeded=missed, retries=retries))

    def _reject(self, it: _Item, error: Exception,
                where: Optional[str]) -> ServeResult:
        if where:
            it.path.append(where)
        latency = self.clock() - it.t_admit
        ddl = it.req.deadline_s if it.req.deadline_s is not None \
            else self.default_deadline_s
        self.counters["rejected"] += 1
        result = ServeResult(None, ServeReport(
            rid=it.rid, n=getattr(it, "n", 0) or 0, status="rejected",
            path=tuple(it.path), bucket=it.bucket, batch=None,
            backend=None, cache=None, latency_s=latency, deadline_s=ddl,
            deadline_exceeded=isinstance(error, DeadlineExceededError),
            error=type(error).__name__, error_msg=str(error)))
        it.result = result
        return result
