"""Open loop: ragged requests arriving at a fixed rate, served by
``ServePlane.serve`` (independent users; a stall delays every request
behind it).

Requests come due as a Poisson process of ``rate`` per second over the
window (``bench.reference.inputs.open_loop_requests``: every seed the
same sizes and poison kinds, in another order); each request is timed
from its due time to the return of the ``serve`` call that answered it.
The driver hands each wave of requests that have come due to
``plane.serve``; requests still unserved when the window closes are
served after it (for at most ``DRAIN_S``), their wait counted.

Parameters: ``rate``; the plane's ``lattice`` ([n_min, n_max, factor] of
``BucketLattice.geometric``), ``max_batch`` and ``cache_entries``; the
sizes (log-normal ``median_n``, ``sigma``, clipped to ``n_min`` ..
``n_max``), ``poison_rate``; ``warm_batches``, the batch widths warmed
at set-up for every bucket; the waves of the traced slice
(``trace_iterations``); and ``check``: ``requests`` clean requests
compared at every target (0: all of them).

Readings: ``attempted`` (requests due), ``latency_s`` (one a request;
inf for a request not answered as it should be), ``lateness_s`` (the
dispatch of each request after its due time), ``dispatched`` (for each
wave, (bucket, batch, n) of each request the plane dispatched) and
``cache_misses`` (both before the traced slice of a traced run),
``window_s`` and ``failed``.
"""
from __future__ import annotations

import functools
import sys
import time

import numpy as np
import torch
from torch.profiler import record_function

from bench.reference.direct import direct_sum, errors
from bench.reference.inputs import open_loop_requests
from repro_torch.serve import (BucketLattice, Request, ServePlane,
                               default_cfg_factory)

from ._common import build_kernels, sample, sync, window_end

#: Seconds past the window's close allowed for the requests due in it.
DRAIN_S = 60.0
#: The typed error each poison kind must be rejected with.
POISON_ERRORS = {"nan-q": "NonFiniteInputError",
                 "inf-z": "NonFiniteInputError", "real-z": "DTypeError",
                 "empty": "ShapeError"}


class Driver:
    def __init__(self, run):
        self.run = run

    def _stream(self, count: int, seconds: float, seed: int):
        p, c = self.run.params, self.run.config
        return open_loop_requests(
            count, seconds, seed, median_n=p["median_n"], sigma=p["sigma"],
            n_min=p["n_min"], n_max=p["n_max"], poison_rate=p["poison_rate"],
            dtype=np.complex128 if c["dtype"] == "f64" else np.complex64)

    def setup(self, seconds: float) -> None:
        run, p, c = self.run, self.run.params, self.run.config
        build_kernels(run.device)
        factory = functools.partial(
            default_cfg_factory, p=c["p"], dtype=c["dtype"],
            strong_cap=c["strong_cap"], weak_cap=c["weak_cap"])
        self.plane = ServePlane(
            BucketLattice.geometric(*p["lattice"]), backend=c["backend"],
            cfg_factory=factory, max_batch=p["max_batch"],
            cache_entries=p["cache_entries"], device=run.device)
        self.plane.warm(batches=p["warm_batches"])
        # one wave through the whole host path, outside the stream
        _, warm = self._stream(8, 1.0, run.seed + 1)
        self.plane.serve([Request(z, q) for _, z, q, _ in warm])
        sync(run.device)
        self.reseed(run.seed, seconds)

    def reseed(self, seed: int, seconds: float) -> None:
        """The window's stream for ``seed`` (part of set-up; the tools
        also serve several seeds' streams on one warmed plane)."""
        self.run.seed = seed
        count = max(1, round(self.run.params["rate"] * seconds))
        self.due, self.reqs = self._stream(count, seconds, seed)

    def window(self, seconds: float, tracer) -> None:
        run, plane = self.run, self.plane
        due, reqs = self.due, self.reqs
        count = len(reqs)
        misses0 = self._misses()
        done = np.full(count, np.inf)
        sent = np.full(count, np.inf)
        self.results = [None] * count
        dispatched = []
        untraced = None         # (waves, misses) before the traced slice
        i = wave = 0
        clock = time.perf_counter
        t0 = clock()
        while i < count:
            now = clock() - t0
            if now >= seconds + DRAIN_S:
                break
            if due[i] > now:
                with record_function("bench::await_requests"):
                    time.sleep(min(due[i] - now, 0.002))
                continue
            j = int(np.searchsorted(due, now, side="right"))
            tracer.before(wave)
            if tracer.active and untraced is None:
                untraced = (len(dispatched), self._misses())
            with record_function("bench::serve"):
                out = plane.serve([Request(z, q) for _, z, q, _ in
                                   reqs[i:j]])
            end = clock() - t0
            sent[i:j] = now
            done[i:j] = end
            self.results[i:j] = out
            dispatched.append([(r.bucket, r.batch, r.n) for _, r in out
                               if r.batch is not None])
            i, wave = j, wave + 1
        tracer.end()
        wall = max(clock() - t0, seconds)
        latency = done - due
        failed = self._failed()
        for k in failed:
            latency[k] = np.inf
        late = sent - due
        fin = late[np.isfinite(late)]
        print(f"generator: {count} requests due in {seconds} s at "
              f"{run.params['rate']}/s; dispatched after due: median "
              f"{np.median(fin) * 1e3:.3f} ms, p95 "
              f"{np.percentile(fin, 95) * 1e3:.3f} ms, max "
              f"{fin.max() * 1e3:.3f} ms; {count - fin.size} never "
              f"dispatched; {wave} waves", file=sys.stderr, flush=True)
        waves, misses = untraced or (len(dispatched), self._misses())
        run.readings.update(
            attempted=count, latency_s=latency.tolist(),
            lateness_s=late.tolist(), dispatched=dispatched[:waves],
            cache_misses=misses - misses0, window_s=wall,
            iterations=wave, failed=len(failed))
        window_end(run)

    def _misses(self) -> int:
        return sum(s["misses"] for s in self.plane.stats()["cache"].values())

    def _failed(self) -> list[int]:
        """Requests not answered as they should be: a clean one not
        served "ok" or "recovered" on "cuda" with a finite phi of its
        length, a poisoned one not rejected with its typed error, any
        one not answered at all."""
        bad = []
        for k, ((n, _, _, kind), res) in enumerate(zip(self.reqs,
                                                       self.results)):
            if res is None:
                bad.append(k)
                continue
            phi, rep = res
            if kind == "ok":
                ok = (rep.status in ("ok", "recovered")
                      and rep.backend == "cuda" and phi is not None
                      and phi.shape == (n,) and bool(np.isfinite(phi).all()))
            else:
                ok = (rep.status == "rejected" and phi is None
                      and rep.error == POISON_ERRORS[kind])
            if not ok:
                bad.append(k)
        return bad

    def release(self) -> None:
        del self.plane
        from repro_torch.solver import FmmSolver
        FmmSolver.cache_clear()
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        """Every failed request (``failed``, exact), and the answers of
        the clean requests served (all of them, or ``requests`` drawn
        from the seed with the largest among them) against the f64
        direct sum at every target: worst ``inf`` and ``rms``."""
        run = self.run
        served = [k for k, ((_, _, _, kind), res) in
                  enumerate(zip(self.reqs, self.results))
                  if kind == "ok" and res is not None
                  and res.phi is not None]
        want = run.params["check"]["requests"]
        if want and want < len(served):
            largest = max(served, key=lambda k: self.reqs[k][0])
            picked = {served[j] for j in sample(run.seed, 2, len(served),
                                                want - 1)} | {largest}
        else:
            picked = set(served)
        worst = {"inf": 0.0, "rms": 0.0}
        for k in sorted(picked):
            _, z, q, _ = self.reqs[k]
            zt = torch.as_tensor(z, device=run.device)
            qt = torch.as_tensor(q, device=run.device)
            ref = direct_sum(zt, zt, qt)
            got = (direct_sum(zt, zt, qt, dtype=torch.bfloat16)
                   if run.control == "bf16" else self.results[k].phi)
            e = errors(got, ref)
            worst = {key: max(worst[key], e[key]) for key in worst}
        return {"failed": float(run.readings["failed"]),
                "phi_err_inf": worst["inf"], "phi_err_rms": worst["rms"]}
