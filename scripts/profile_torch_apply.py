#!/usr/bin/env python3
"""Where the time of one FMM apply goes on the CUDA card (PyTorch port).

    python3 scripts/profile_torch_apply.py

For ``fmm_config(1 << 20, p=17)`` in f32 and in f64, on uniform
particles (seed 0), it traces one ``FmmSolver.apply`` with
``torch.profiler`` and prints: the apply's wall time, the summed device
time, the device's busy share and its number of device operations; for
each ``fmm::<phase>`` range that the pipeline marks (tree, connectivity,
upward, downward, evaluation, unsort) its span on the host, the device
time of the kernels launched inside it and its span on the device's
timeline; and the device kernels that take the most time, with their
launch counts.

Needs a CUDA card; exits nonzero without one.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

N = 1 << 20
TOP = 12


def profile_one(dtype: str, torch) -> None:
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import fmm_config
    from repro_torch.data import particles
    from repro_torch.solver import FmmSolver

    cfg = fmm_config(N, p=17, dtype=dtype)
    z, q = particles("uniform", N, 0)
    solver = FmmSolver.build(cfg)
    for _ in range(2):                     # builds the kernels, warms up
        solver.apply(z, q)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solver.apply(z, q)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    averages = prof.key_averages()
    phases = [e for e in averages if e.key.startswith("fmm::")
              and str(e.device_type).endswith("CPU")]
    kernels = [e for e in averages if not e.key.startswith("fmm::")
               and str(e.device_type).endswith("CUDA")]
    spans = {e.key: e.self_device_time_total for e in averages
             if e.key.startswith("fmm::")
             and str(e.device_type).endswith("CUDA")}
    dev_us = sum(e.self_device_time_total for e in kernels)
    print(f"{torch.cuda.get_device_name(0)}; N={N} {dtype}: profiled apply "
          f"wall {1e3 * wall:.2f} ms, device time {dev_us / 1e3:.2f} ms, "
          f"device busy {100 * dev_us / 1e6 / wall:.1f}%, "
          f"{sum(e.count for e in kernels)} device ops")
    print("  phase          host ms   device ms   device span ms")
    for e in phases:
        span = spans.get(e.key)
        print(f"  {e.key[5:]:13s} {e.cpu_time_total / 1e3:8.2f}  "
              f"{e.device_time_total / 1e3:9.3f}   "
              + ("not traced" if span is None else f"{span / 1e3:9.3f}"))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:TOP]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
              f"{e.key[:90]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_apply: no CUDA card", file=sys.stderr)
        return 2
    for dtype in ("f32", "f64"):
        profile_one(dtype, torch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
