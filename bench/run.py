#!/usr/bin/env python3
"""Run one cell of the benchmark once on the CUDA card.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell's driver (``bench/traffic/<driver>.py``) sets up the port
(``repro_torch``) and its inputs from ``--seed``, warms every shape the
cell uses, then runs the window for ``--seconds``. The port's state is
freed and its outputs compared with the plain reference
(``bench/reference``). The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones, read by
``bench/metrics/<name>.py``), ``device`` and, traced, ``breakdown``; its
last key, ``checks``, holds each number compared with its limit, which
are also the last lines of standard error.

Exits 2, printing no result, without a CUDA card (there is no CPU
fall-back), without the port beside the benchmark, or when JAX or the
JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def fail(msg: str) -> int:
    print(f"bench: {msg}", file=sys.stderr, flush=True)
    return 2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from bench import harness
    from bench.tracing import Tracer

    bench = harness.benchmark()
    entry = next((w for w in bench["workloads"]
                  if w["name"] == args.workload), None)
    if entry is None:
        return fail(f"no cell {args.workload!r} in BENCHMARK.json")
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < entry["chips"]:
        return fail(f"{args.workload} needs {entry['chips']} CUDA card(s); "
                    f"this process has {torch.cuda.device_count()}")
    if not (ROOT / "src" / "repro_torch").is_dir():
        return fail("the port (src/repro_torch) is not beside the benchmark")

    cell = harness.cell(args.workload)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    run = harness.Run(cell=cell, seed=args.seed, device=device,
                      trace=bool(args.trace))
    driver = harness.driver_class(cell["traffic"])(run)
    tracer = Tracer(run.trace, cell["params"].get("trace_iterations", 0),
                    device, args.seconds)
    driver.setup(args.seconds)
    tracer.warm()
    # what set-up made lives to the end: keep it out of the collector's
    # generations, so that no collection in the window walks it
    gc.collect()
    gc.freeze()
    torch.cuda.synchronize(device)
    run.setup_seconds = time.perf_counter() - T_START

    driver.window(args.seconds, tracer)
    run.digest = tracer.finish()
    run.peak_bytes = torch.cuda.max_memory_reserved(device)

    driver.release()
    numbers = driver.check()
    checks = {k: {"value": v, "limit": run.limits[k]}
              for k, v in numbers.items() if k in run.limits}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    for c in checks.values():        # JSON has no infinity or NaN
        if not math.isfinite(c["value"]):
            c["value"] = repr(c["value"])

    metrics = {}
    for m in harness.cell_metrics(bench, args.workload, run.trace):
        read, scope = harness.reader(m["name"])
        value = read(run, scope)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    loaded = harness.forbidden_modules()
    if loaded:
        return fail(f"JAX or the JAX package was loaded: {loaded}")

    out = {"correct": correct,
           "attempted": run.readings.get("attempted",
                                         run.readings["iterations"]),
           "failed": run.readings["failed"], "metrics": metrics,
           "device": {"platform": "gpu",
                      "kind": torch.cuda.get_device_name(device),
                      "count": 1, "memory_peak_bytes": run.peak_bytes}}
    if run.digest is not None:
        out["device"].update(busy_s=run.digest.busy_s,
                             window_s=run.digest.window_s)
        out["breakdown"] = run.digest.breakdown()
    out["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
