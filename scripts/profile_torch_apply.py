#!/usr/bin/env python3
"""Where the time of one FMM apply goes on the CUDA card (PyTorch port).

    python3 scripts/profile_torch_apply.py [--backend cuda|phases]

For ``fmm_config(1 << 20, p=17)`` in f32 and in f64, on uniform
particles (seed 0), it traces with ``torch.profiler``

* the eager pipeline of one apply: ``fmm_build`` and ``fmm_evaluate``
  with the backend's hooks, called directly (what the solver's apply
  program captures), and prints its wall time, the summed device time,
  the device's busy share and its number of device operations; for each
  ``fmm::<phase>`` range that the pipeline marks (tree, connectivity,
  upward, downward, evaluation, unsort; on the per-phase path also
  m2l[<level>], l2p, m2p and p2p) and each ``kernel::<name>`` range
  around a hand-written kernel's launch, its span on the host, the
  device time of the kernels launched inside it and its span on the
  device's timeline; and the device kernels that take the most time,
  with their launch counts;
* one replayed ``FmmSolver.apply`` (its program captured by two calls
  before the trace): the same totals and top kernels. A replay runs no
  Python, so it has no ``fmm::`` ranges.

``--backend cuda`` (the default) profiles the main path; ``--backend
phases`` the per-phase path: the "cuda" backend without its fused
hooks, registered here as "cuda-phases", so M2L runs one launch per
level and L2P and P2P each one launch of their own.

Needs a CUDA card; exits nonzero without one.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

N = 1 << 20
TOP = 12


def backend_name(which: str, torch) -> str:
    """The registered backend to profile: "cuda", or the per-phase one."""
    if which == "cuda":
        return "cuda"
    from repro_torch.solver import get_backend, register_backend
    return register_backend(dataclasses.replace(
        get_backend("cuda", torch.device("cuda")), name="cuda-phases",
        m2l_fused=None, eval_fused=None)).name


def _is(e, kind: str) -> bool:
    return str(e.device_type).endswith(kind)


def hand_written_by_range(prof) -> dict | None:
    """Microseconds of hand-written kernels launched inside each
    ``fmm::`` range: the i-th device span of a ``kernel::<name>`` range
    belongs to its i-th host range, and counts for every ``fmm::`` range
    that encloses that host range. None if the two do not pair up."""
    events = prof.events()
    host = [e for e in events if _is(e, "CPU")
            and e.name.startswith(("fmm::", "kernel::"))]
    phases = [e for e in host if e.name.startswith("fmm::")]
    out: dict = {}
    for name in {e.name for e in host if e.name.startswith("kernel::")}:
        h = sorted((e for e in host if e.name == name),
                   key=lambda e: e.time_range.start)
        d = sorted((e for e in events if _is(e, "CUDA") and e.name == name),
                   key=lambda e: e.time_range.start)
        if len(h) != len(d):
            return None
        for he, de in zip(h, d):
            for ph in phases:
                if (ph.time_range.start <= he.time_range.start
                        and he.time_range.end <= ph.time_range.end):
                    out[ph.name] = out.get(ph.name, 0.0) + \
                        de.time_range.elapsed_us()
    return out


def traced(fn, torch):
    """(the profiler, the wall seconds) of one call of ``fn`` ending in a
    synchronize."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return prof, wall


def summary(prof, wall: float, what: str, torch) -> list:
    """Print the trace's totals and top device kernels; return the
    averages of the ``fmm::``/``kernel::`` ranges and the device spans."""
    averages = prof.key_averages()
    ranges = ("fmm::", "kernel::")
    kernels = [e for e in averages if not e.key.startswith(ranges)
               and str(e.device_type).endswith("CUDA")]
    dev_us = sum(e.self_device_time_total for e in kernels)
    print(f"{torch.cuda.get_device_name(0)}; {what}: "
          f"wall {1e3 * wall:.2f} ms, device time {dev_us / 1e3:.2f} ms, "
          f"device busy {100 * dev_us / 1e6 / wall:.1f}%, "
          f"{sum(e.count for e in kernels)} device ops")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:TOP]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
              f"{e.key[:90]}")
    return averages


def profile_one(dtype: str, backend: str, torch) -> None:
    from torch.profiler import record_function

    from repro_torch.configs import fmm_config
    from repro_torch.core.fmm import fmm_build, fmm_evaluate, unsort
    from repro_torch.data import particles
    from repro_torch.solver import FmmSolver

    cfg = fmm_config(N, p=17, dtype=dtype)
    z, q = particles("uniform", N, 0)
    solver = FmmSolver.build(cfg, backend=backend)
    be = solver.backend
    zb, qb = (a.to(cfg.torch_complex)[None] for a in (z, q))

    def eager():
        plan = fmm_build(zb, qb, cfg, **be.topology_impls())
        phi = fmm_evaluate(plan, cfg, **be.phase_impls())
        with record_function("fmm::unsort"):
            return unsort(phi, plan.tree.perm)

    for _ in range(2):           # builds the kernels; apply: eager, capture
        eager()
        solver.apply(z, q)

    prof, wall = traced(eager, torch)
    averages = summary(prof, wall, f"backend {backend}; N={N} {dtype}: "
                       "eager pipeline of one apply", torch)
    ranges = ("fmm::", "kernel::")
    phases = [e for e in averages if e.key.startswith(ranges)
              and str(e.device_type).endswith("CPU")]
    spans = {e.key: e.self_device_time_total for e in averages
             if e.key.startswith(ranges)
             and str(e.device_type).endswith("CUDA")}
    own = hand_written_by_range(prof)
    print("  range               calls   host ms   torch device ms   "
          "hand-written kernels ms   device span ms")
    for e in phases:
        span = spans.get(e.key)
        mine = ("" if e.key.startswith("kernel::") else "not paired"
                if own is None else f"{own.get(e.key, 0.0) / 1e3:.3f}")
        print(f"  {e.key:20s} {e.count:5d} {e.cpu_time_total / 1e3:8.2f}  "
              f"{e.device_time_total / 1e3:15.3f}   {mine:>23s}   "
              + ("not traced" if span is None else f"{span / 1e3:9.3f}"))

    prof, wall = traced(lambda: solver.apply(z, q), torch)
    summary(prof, wall, f"backend {backend}; N={N} {dtype}: replayed "
            "apply (its program)", torch)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--backend", choices=("cuda", "phases"), default="cuda")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_apply: no CUDA card", file=sys.stderr)
        return 2
    backend = backend_name(args.backend, torch)
    for dtype in ("f32", "f64"):
        profile_one(dtype, backend, torch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
