"""Deterministic fault injection for the serving plane.

The twin of ``repro.testing.serve_faults``. ``repro_torch.testing.faults``
drives the *per-call* recovery ladder; this module drives the
*per-fleet* layer above it — the ``ServePlane``'s admission control,
keyed solver cache, and degradation ladder. Each injector forces one
serving failure mode:

  poison_request    corrupt one request in a stream (NaN charge, Inf
                    position, real-dtype z, or empty arrays) — must be
                    refused at admission as a typed rejection without
                    contaminating the batch it would have ridden in
  cache_thrash      clamp the plan cache to one entry, so every bucket
                    switch evicts and re-prepares — eviction counters
                    must tick and results must stay correct
  compile_storm     swap in a dense bucket lattice so nearly every
                    distinct N is its own shape class — the worst-case
                    amplification the geometric lattice exists to
                    prevent; serving must stay correct (just slow)
  latency_spike     make every k-th guarded dispatch sleep — the
                    ``StragglerMonitor`` wired into the plane must flag
                    the spiked dispatches ``slow`` in their reports

The context managers patch at instance/class seams and restore on exit.
Unlike the solver-level injectors they do NOT clear the solver cache:
the serving faults are *above* the solvers, which stay healthy
throughout.

On the card ``cache_thrash`` and ``compile_storm`` mean many program
captures, and releases as the solver LRU and the programs' memory budget
evict; each gate's line ends with the programs the cached solvers hold
and, on the card, the pool bytes the programs hold, the solvers the
budget has released and the memory reserved.

The soak (ragged log-normal traffic through every injector, five phases
with the reference's gates; every fault must be visible in a report and
nothing may raise; on the CUDA card unless ``--device cpu``):

    PYTHONPATH=src python -m repro_torch.testing.serve_faults [--device cpu]
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from ..serve.plane import ServePlane
from ..solver.guard import GuardedSolver
from ..solver.program import program_memory
from ..solver.solver import FmmSolver


# ---------------------------------------------------------------------------
# poison request (admission-control family)
# ---------------------------------------------------------------------------

POISON_KINDS = ("nan-q", "inf-z", "real-z", "empty")


def poison_request(z, q, kind: str = "nan-q", idx: int = 0):
    """Corrupt one (z, q) pair the way ragged traffic does (the same
    flavors ``repro_torch.data.ragged_requests`` injects). Returns new arrays;
    the originals are untouched."""
    z = np.asarray(z)
    q = np.asarray(q)
    if kind == "nan-q":
        q = q.copy()
        q[idx] = np.nan
    elif kind == "inf-z":
        z = z.copy()
        z[idx] = np.inf + 0j
    elif kind == "real-z":
        z = z.real.copy()
    elif kind == "empty":
        z, q = z[:0], q[:0]
    else:
        raise ValueError(f"unknown poison kind {kind!r}; "
                         f"pick from {POISON_KINDS}")
    return z, q


# ---------------------------------------------------------------------------
# cache pressure (keyed-solver-cache family)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def cache_thrash(plane: ServePlane, max_entries: int = 1):
    """Clamp the plane's solver cache to ``max_entries`` so every bucket
    switch evicts: the eviction path runs on every dispatch.
    Restores the original capacity (and nothing else) on exit — evicted
    entries stay evicted, exactly like real cache pressure."""
    orig = plane.cache.max_entries
    plane.cache.max_entries = max(1, int(max_entries))
    while len(plane.cache._entries) > plane.cache.max_entries:
        (b, _, _), _ = plane.cache._entries.popitem(last=False)
        plane.cache._bucket_stats(b)["evictions"] += 1
    try:
        yield plane
    finally:
        plane.cache.max_entries = orig


@contextlib.contextmanager
def compile_storm(plane: ServePlane, step: int = 8):
    """Swap the plane's geometric lattice for a dense stride-``step``
    one: nearly every distinct N becomes its own shape class, so traffic
    that the geometric lattice would serve from a handful of solvers
    prepares one per size — the worst case the bucketing design
    amortizes. Serving must remain correct under it."""
    from ..serve.buckets import BucketLattice

    orig = plane.lattice
    lo = orig.sizes[0]
    hi = orig.max_size
    dense = tuple(range(lo, hi + 1, max(1, int(step))))
    if dense[-1] != hi:
        dense = dense + (hi,)
    plane.lattice = BucketLattice(sizes=dense)
    try:
        yield plane
    finally:
        plane.lattice = orig


# ---------------------------------------------------------------------------
# latency spike (straggler-detection family)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def latency_spike(every: int = 3, spike_s: float = 0.25,
                  sleep=time.sleep):
    """Make every ``every``-th guarded batched dispatch sleep ``spike_s``
    before returning — a deterministic straggler. The plane's
    ``StragglerMonitor`` must flag those dispatches (``slow=True`` in
    the affected ``ServeReport``s). Patches at the ``GuardedSolver``
    class seam (the public ``GuardedSolver.apply_batched_guarded``) so it
    hits cached solvers too."""
    real = GuardedSolver.apply_batched_guarded
    state = {"calls": 0}

    def spiked(self, z, q):
        state["calls"] += 1
        out = real(self, z, q)
        if state["calls"] % max(1, int(every)) == 0:
            sleep(spike_s)
        return out

    GuardedSolver.apply_batched_guarded = spiked
    try:
        yield state
    finally:
        GuardedSolver.apply_batched_guarded = real


# ---------------------------------------------------------------------------
# the soak: ragged traffic through every injector, zero unhandled errors
# ---------------------------------------------------------------------------

def run_soak(device=None, log=print, clock=time.perf_counter,
             sleep=time.sleep):
    """The soak's five phases on ``device`` (default: the CUDA card),
    each with the reference's gate. Returns ``(failures, served)``:
    the names of the gates that failed, and ``(phase, kind, phi,
    report)`` for every request served (``kind`` is "ok" or the poison).
    ``clock``/``sleep`` go to every plane and to the latency spike (a
    test's injected clock makes the spike phase independent of the
    host's load)."""
    from ..data.synthetic import ragged_requests
    from ..serve import BucketLattice, Request

    failures: list[str] = []
    served: list[tuple] = []

    def memory() -> str:
        """Programs held by the cached solvers, and on the card the
        memory the caching allocator reserves (graph pools included)."""
        held = sum(s._compiled_program_count()
                   for s in FmmSolver._cached_solvers())
        out = f"; programs held {held}"
        if torch.cuda.is_available() and plane.device.type == "cuda":
            mem = program_memory(plane.device)
            out += (f", pools {mem['held']} B (budget {mem['budget']} B, "
                    f"{mem['released_sets']} solvers released), reserved "
                    f"{torch.cuda.memory_reserved(plane.device)} B")
        return out

    def gate(name, ok, detail=""):
        log(("ok    " if ok else "FAIL  ") + f"{name:<32s} {detail}"
            + memory())
        if not ok:
            failures.append(name)

    def plane_for(**kw):
        kw.setdefault("max_batch", 4)
        kw.setdefault("direct_max", 512)
        return ServePlane(BucketLattice(sizes=(32, 64, 128)),
                          device=device, clock=clock, sleep=sleep, **kw)

    def traffic(num, seed, poison_rate=0.0, n_max=400):
        return [(Request(z, q), kind) for _, z, q, kind in
                ragged_requests(num, seed=seed, median_n=48, sigma=0.7,
                                n_max=n_max, poison_rate=poison_rate)]

    def run(phase, plane, wave):
        results = plane.serve([r for r, _ in wave])
        served.extend((phase, kind, phi, rep)
                      for (_, kind), (phi, rep) in zip(wave, results))
        return results

    # phase 1 — poisoned ragged stream: every poison refused as a typed
    # rejection, every clean request served, nothing raises
    plane = plane_for()
    bad: list[str] = []
    n_served = rejected = 0
    for s in (0, 1):
        wave = traffic(12, seed=s, poison_rate=0.3)
        for (req, kind), (phi, rep) in zip(wave,
                                           run("poison-stream", plane, wave)):
            log("    " + kind + " " + rep.summary())
            if kind == "ok":
                ok = rep.status in ("ok", "recovered", "degraded") \
                    and phi is not None and np.all(np.isfinite(phi))
                n_served += 1
            else:
                ok = rep.status == "rejected" and rep.error is not None \
                    and phi is None
                rejected += 1
            if not ok:
                bad.append(f"req{rep.rid}:{kind}")
    gate("poison-stream", not bad,
         f"{n_served} served, {rejected} typed rejections"
         + (f"; wrong: {bad}" if bad else ""))

    # phase 2 — cache thrash: one-entry cache, alternating buckets;
    # evictions must tick, answers must stay finite
    plane = plane_for()
    with cache_thrash(plane, max_entries=1):
        results = run("cache-thrash", plane, traffic(8, seed=7, n_max=120))
        bad = [rep.rid for phi, rep in results
               if rep.status == "rejected" or phi is None
               or not np.all(np.isfinite(phi))]
    ev = sum(s.evictions for s in plane.cache.info().values())
    gate("cache-thrash", not bad and ev > 0,
         f"evictions={ev}, cache_size={len(plane.cache)}")

    # phase 3 — compile storm: dense lattice, each size its own solver;
    # correctness must survive the worst-case amplification
    plane = plane_for()
    with compile_storm(plane, step=16):
        results = run("compile-storm", plane, traffic(6, seed=11, n_max=120))
        bad = [rep.rid for phi, rep in results
               if rep.status == "rejected" or phi is None]
        buckets = {rep.bucket for _, rep in results}
    gate("compile-storm", not bad and len(buckets) >= 3,
         f"{len(buckets)} distinct shape classes prepared")

    # phase 4 — latency spike: every 2nd dispatch sleeps; the straggler
    # monitor must mark at least one dispatch slow in its reports
    plane = plane_for()
    run("latency-spike", plane, traffic(6, seed=13, n_max=120))   # warm
    with latency_spike(every=2, spike_s=0.5, sleep=sleep):
        results = run("latency-spike", plane,
                      traffic(10, seed=17, n_max=120))
    slow = [rep.rid for _, rep in results if rep.slow]
    gate("latency-spike", len(slow) > 0,
         f"slow reports: {slow or 'none'}")

    # phase 5 — deadline pressure: a budget no dispatch can meet must
    # surface as DeadlineExceededError, never hang or raise
    plane = plane_for()
    wave = [(Request(r.z, r.q, deadline_s=0.0), kind)
            for r, kind in traffic(4, seed=19, n_max=120)]
    results = run("deadline-pressure", plane, wave)
    ddl = [rep for phi, rep in results
           if rep.status == "rejected" and rep.error ==
           "DeadlineExceededError" and rep.deadline_exceeded]
    gate("deadline-pressure", len(ddl) == len(results),
         f"{len(ddl)}/{len(results)} shed at admission")

    stats = plane.stats()
    log(f"soak stats (last plane): {stats['requests']} requests, "
        f"{stats['dispatches']} dispatches, "
        f"median dispatch {stats['dispatch_median_s']:.3f}s")
    return failures, served


def _soak(argv=None) -> int:     # pragma: no cover - run as a script
    import argparse

    ap = argparse.ArgumentParser(
        description="Ragged traffic through every serving fault.")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    print("serve-soak: ragged traffic through every serving fault")
    failures, _ = run_soak(args.device)
    dt = time.perf_counter() - t0
    print(f"serve-soak: "
          f"{'FAILED ' + ','.join(failures) if failures else 'all ok'} "
          f"({dt:.1f}s, zero unhandled exceptions)")
    return 1 if failures else 0


if __name__ == "__main__":     # pragma: no cover
    raise SystemExit(_soak())
