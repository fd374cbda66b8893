#!/usr/bin/env python3
"""The highest rate a serving cell sustains, by a sweep on the card.

    python3 bench/tools/sweep_serve.py --workload f32-serve-ragged \
        --rates 40,80,120 --seconds 10 [--seed N]

Sets the cell's plane up once, then serves one open-loop window a rate
(the cell's driver, the rate overridden) and prints a JSON line a rate:
requests, clean requests completed per second of window, latency p50 /
p95 / p99, and how late the generator dispatched in the first and the
last quarter of the window. A backlog that grows over the window shows
as a last quarter far later than the first.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=3_200_000_000)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from bench import harness
    from bench.tracing import Tracer

    if not torch.cuda.is_available():
        print("sweep: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = harness.cell(args.workload)
    rates = [float(r) for r in args.rates.split(",")]
    cell["params"]["rate"] = rates[0]
    run = harness.Run(cell=cell, seed=args.seed, device=device)
    driver = harness.driver_class(cell["traffic"])(run)
    driver.setup(args.seconds)
    for k, rate in enumerate(rates):
        cell["params"]["rate"] = rate
        run.readings = {}
        driver.reseed(args.seed + k, args.seconds)
        driver.window(args.seconds, Tracer(False, 0, device))
        lat = np.asarray(run.readings["latency_s"]) * 1e3
        late = np.asarray(run.readings["lateness_s"]) * 1e3
        q = len(late) // 4
        clean = sum(1 for (_, _, _, kind), res in
                    zip(driver.reqs, driver.results)
                    if kind == "ok" and res is not None
                    and res.phi is not None)
        print(json.dumps({
            "rate": rate, "requests": len(lat),
            "clean_per_s": clean / run.readings["window_s"],
            "window_s": run.readings["window_s"],
            "waves": run.readings["iterations"],
            "failed": run.readings["failed"],
            "p50_ms": float(np.percentile(lat, 50)),
            "p95_ms": float(np.percentile(lat, 95)),
            "p99_ms": float(np.percentile(lat, 99)),
            "late_first_quarter_ms": float(np.median(late[:q])),
            "late_last_quarter_ms": float(np.median(late[-q:])),
            "cache_misses": run.readings["cache_misses"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
