"""Ragged, partially poisoned traffic through the PyTorch port's serving
plane — the twin of ``examples/serve_traffic.py``.

Generates a log-normal request stream (every request a different N, a
fraction poisoned), warms the plane's shape classes, and serves wave
after wave — printing a ``ServeReport`` line a request and the plane's
cumulative stats (per-bucket cache traffic, straggler median, deadline
misses) at the end. Nothing a request can contain crashes the plane: it
returns a trustworthy phi or a typed rejection.

    python examples/torch_serve_traffic.py --num 24 \
        [--poison 0.2] [--deadline 30] [--median-n 128]
    python examples/torch_serve_traffic.py --num 8 --device cpu

Runs on the CUDA card unless ``--device cpu``. Requests above the
lattice's largest bucket (1024) and at most ``direct_max`` (4096) take
the designed ``oversize->direct`` step, the plain O(N^2) sum: on the
card each such request warns (``BackendDowngradeWarning``), and this
example lets the warning through.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np

from repro_torch.data import ragged_requests
from repro_torch.serve import BucketLattice, Request, ServePlane


def run(num: int = 24, poison: float = 0.2, median_n: int = 128,
        deadline: float | None = None, waves: int = 2, device=None,
        log=print) -> dict:
    """The reference example's waves. Returns the warm-up seconds and,
    a wave, its requests ``(n, z, q, kind)``, their ``(phi, report)``
    results and its seconds; and the plane's final ``stats()``."""
    lattice = BucketLattice.geometric(64, 1024)
    plane = ServePlane(lattice, max_batch=4, direct_max=4096,
                       default_deadline_s=deadline, device=device)
    log(f"lattice: {lattice.sizes}; warming shape classes on "
        f"{plane.device} ...")
    t0 = time.perf_counter()
    plane.warm(batches=(1, 4))
    out = dict(warm_s=time.perf_counter() - t0, waves=[])
    log(f"warmed {len(plane.cache)} executables in {out['warm_s']:.1f}s")

    for wave in range(waves):
        reqs = list(ragged_requests(num, seed=wave, median_n=median_n,
                                    sigma=0.8, n_max=2048,
                                    poison_rate=poison))
        t0 = time.perf_counter()
        results = plane.serve([Request(z, q) for _, z, q, _ in reqs])
        dt = time.perf_counter() - t0
        out["waves"].append(dict(requests=reqs, results=results, secs=dt))
        log(f"\nwave {wave}: {len(reqs)} requests in {dt:.2f}s "
            f"({len(reqs) / dt:.1f} req/s)")
        for phi, report in results:
            log(f"  {report.summary()}")

    out["stats"] = stats = plane.stats()
    log("\ncumulative: " + str(
        {k: stats[k] for k in ("requests", "ok", "recovered", "degraded",
                               "rejected", "dispatches", "slow_dispatches",
                               "deadline_misses")}))
    log("cache (per bucket): " + str(
        {b: "hits={hits} misses={misses} evictions={evictions}".format(**s)
         for b, s in stats["cache"].items()}))
    med = stats["dispatch_median_s"]
    if np.isfinite(med):
        log(f"dispatch median: {med * 1e3:.1f}ms")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--num", type=int, default=24)
    ap.add_argument("--poison", type=float, default=0.2)
    ap.add_argument("--median-n", type=int, default=128)
    ap.add_argument("--deadline", type=float, default=None,
                    help="per-request deadline budget in seconds")
    ap.add_argument("--waves", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    run(args.num, args.poison, args.median_n, args.deadline, args.waves,
        args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
