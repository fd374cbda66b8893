#!/usr/bin/env python3
"""The readings that a cell's correctness limits are set from, on the card.

    python3 bench/tools/readings.py --workload <cell> --seeds 12 \
        --seconds 2 --control f32|bf16 --control-seeds 3 [--first N]

Runs the cell's driver (set-up, a window of ``--seconds``, release,
check) for ``--seeds`` seeds of the program and ``--control-seeds``
seeds of the control, all in one process, and prints one JSON line a
seed with every number the check computes, then the largest reading of
each number over the program's seeds (the lower reading of its limit)
and the smallest over the control's (the upper reading). The control is
the nearest precision below the configuration's: ``f32``, the program's
own f32 path in place of f64; ``bf16``, the reference computed in
bfloat16 in place of the program. A driver with ``reseed`` (the serving
driver) sets up once and serves every seed's stream on the same plane.
Seeds are ``--first`` + i (control: after the program's).
"""
from __future__ import annotations

import argparse
import copy
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", choices=("f32", "bf16"), required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--first", type=int, default=3_100_000_000)
    args = ap.parse_args(argv)

    import torch

    from bench import harness
    from bench.tracing import Tracer

    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    base = harness.cell(args.workload)
    plan = [(args.first + i, None) for i in range(args.seeds)] + \
        [(args.first + args.seeds + i, args.control)
         for i in range(args.control_seeds)]
    worst: dict = {}
    shared = None
    for seed, control in plan:
        cell = copy.deepcopy(base)
        if control == "f32":
            cell["config"]["dtype"] = "f32"
        run = harness.Run(cell=cell, seed=seed, device=device,
                          control="bf16" if control == "bf16" else None)
        t0 = time.perf_counter()
        if hasattr(harness.driver_class(cell["traffic"]), "reseed") and \
                shared is not None and control != "f32":
            driver = shared
            driver.run = run
            driver.reseed(seed, args.seconds)
        else:
            driver = harness.driver_class(cell["traffic"])(run)
            driver.setup(args.seconds)
        setup = time.perf_counter() - t0
        driver.window(args.seconds, Tracer(False, 0, device))
        if hasattr(driver, "reseed"):
            shared = driver
        else:
            driver.release()
        numbers = driver.check()
        side = "control" if control else "program"
        for k, v in numbers.items():
            rec = worst.setdefault(k, {"program": 0.0,
                                       "control": float("inf")})
            rec[side] = (max if side == "program" else min)(rec[side], v)
        small = {k: v for k, v in run.readings.items()
                 if not isinstance(v, list) or k == "caps"}
        print(json.dumps({"seed": seed, "side": side, "control": control,
                          "setup_s": setup, "numbers": numbers,
                          "readings": small}), flush=True)
    print(json.dumps({"workload": args.workload, "limits": base["limits"],
                      "lower_upper": worst}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
